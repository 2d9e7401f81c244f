// CommitteeLedger — the native replicated FL coordinator.
//
// TPU-native re-design of the reference's on-chain coordinator
// (reference: FISCO-BCOS/libprecompiled/extension/CommitteePrecompiled.{h,cpp}):
// the same 6-method protocol surface (RegisterNode / QueryState /
// QueryGlobalModel / UploadLocalUpdate / UploadScores / QueryAllUpdates,
// .cpp:47-52) and the same round state machine (collect K updates -> collect
// committee scores -> median-rank -> top-k select -> advance epoch -> re-elect,
// .cpp:349-456), with these deliberate differences:
//
// - Tensors never enter the ledger.  Where the contract stores models and
//   deltas as nested JSON strings in a replicated KV table (.cpp:32-44), this
//   ledger records 32-byte content hashes; the tensor bytes stay in device
//   memory and move over ICI collectives (BASELINE.json north star).
// - Replication is an append-only hash-chained op log instead of PBFT: every
//   accepted mutation is serialized into the log and chained with SHA-256.
//   Replicas that apply the same op stream provably hold the same state
//   (verify via the head digest); this is the "blockchain records hashes"
//   property without consensus machinery the demo never exercises.
// - Determinism is specified, not accidental: genesis committee = first
//   COMM_COUNT registrants in arrival order (the reference uses unordered_map
//   iteration order, .cpp:177-182); ranking = median desc, slot asc (stable);
//   median = mean of the two middle values (the reference's GetMid has an
//   even/odd quirk, .cpp:102-110 — see SURVEY.md §3.4).
// - UploadScores re-upload replaces the row and does NOT bump score_count
//   (the reference increments unconditionally, .cpp:279-289 — a quirk that
//   could fire aggregation with missing committee rows).
//
// Single-threaded by construction, like the contract under PBFT ordering; the
// serialization point is whoever owns the handle (the Python binding holds the
// GIL; the multi-host runtime funnels ops through one writer).

#pragma once

#include <cstdint>
#include <cstdio>
#include <map>
#include <optional>
#include <string>
#include <unordered_map>
#include <vector>

#include "sha256.h"

namespace bflc {

enum class Status : int32_t {
  OK = 0,
  NOT_STARTED = 1,      // epoch still at genesis sentinel (registration phase)
  WRONG_EPOCH = 2,      // stale upload (.cpp:225-226, 266-269)
  DUPLICATE = 3,        // second upload by same sender this round (.cpp:232-233)
  CAP_REACHED = 4,      // update_count at needed_update_count (.cpp:239-244)
  NOT_COMMITTEE = 5,    // scores from a non-committee sender (.cpp:272-275)
  ALREADY_REGISTERED = 6,
  NOT_READY = 7,        // commit without a pending aggregation
  BAD_ARG = 8,
};

enum class Role : int32_t { TRAINER = 0, COMMITTEE = 1 };

struct LedgerConfig {
  int64_t client_num = 20;
  int64_t comm_count = 4;
  int64_t aggregate_count = 6;
  int64_t needed_update_count = 10;
  int64_t genesis_epoch = -999;
};

struct UpdateRecord {
  std::string sender;
  Digest payload_hash;
  int64_t n_samples = 0;
  float avg_cost = 0.f;
};

// Outcome of a completed scoring phase, fixed until commit_model.
struct PendingAggregate {
  std::vector<float> medians;        // per slot
  std::vector<int32_t> order;        // slots, best first (median desc, slot asc)
  std::vector<int32_t> selected;     // top-aggregate_count slots, best first
  float global_loss = 0.f;           // mean avg_cost of selected (.cpp:416-425)
};

class CommitteeLedger {
 public:
  explicit CommitteeLedger(const LedgerConfig& cfg);

  // --- the 6-method protocol surface ---
  Status register_node(const std::string& addr);
  // role defaults to TRAINER for unknown addresses without persisting,
  // matching QueryState (.cpp:191-205).
  void query_state(const std::string& addr, Role* role, int64_t* epoch) const;
  void query_global_model(Digest* model_hash, int64_t* epoch) const;
  Status upload_local_update(const std::string& sender, const Digest& payload,
                             int64_t n_samples, float avg_cost, int64_t epoch);
  // scores are slot-ordered (slot i scores update i); len must equal the
  // current update_count.
  Status upload_scores(const std::string& sender, int64_t epoch,
                       const float* scores, size_t len);
  // empty until update_count >= needed_update_count (.cpp:304-311) or the
  // round was closed early by close_round().
  std::vector<UpdateRecord> query_all_updates() const;

  // --- failure-recovery extensions (no reference equivalent: a dead
  // committee member deadlocks the reference round, SURVEY.md §5) ---
  // Close an under-filled round so scoring can proceed with the updates
  // present (trainer-failure path).  Requires >= aggregate-worthy updates.
  Status close_round();
  // Fire aggregation with the committee rows present (dead-committee path).
  // Requires at least one score row.
  Status force_aggregate();
  // Mid-round committee re-election: seat `addrs` (registered clients) as
  // the committee so a round whose committee died entirely can still be
  // scored.  Rows already uploaded by former members stay valid.  The
  // reference has no equivalent — "nothing re-elects mid-round"
  // (SURVEY.md §5).
  Status reseat_committee(const std::vector<std::string>& addrs);
  bool round_closed() const { return closed_; }

  // --- writer fencing (split-brain defense) ---
  // Record a writer promotion IN the replicated log: the fence (generation)
  // must advance by exactly one per promotion.  Replicas replaying the
  // chain agree on the current writer; a server observing a higher fence
  // than its own must self-demote (enforced in comm.ledger_service — the
  // reference gets the equivalent no-fork guarantee from PBFT,
  // README.md:162-183).  Valid at any epoch, including genesis: a writer
  // can die before round 0 commits.
  Status promote_writer(int64_t generation, int64_t writer_index);
  int64_t generation() const { return generation_; }
  int64_t writer_index() const { return writer_index_; }

  // --- aggregation handshake with the compute plane ---
  bool aggregate_ready() const { return pending_.has_value(); }
  const PendingAggregate* pending() const {
    return pending_ ? &*pending_ : nullptr;
  }
  // Called by the compute plane after it produced the new global model on
  // device; performs epoch advance + committee re-election + round reset
  // (.cpp:416-455) and records the model hash.
  Status commit_model(const Digest& new_model_hash, int64_t epoch);

  // --- inspection ---
  int64_t epoch() const { return epoch_; }
  int64_t num_registered() const { return static_cast<int64_t>(roles_.size()); }
  int64_t update_count() const { return static_cast<int64_t>(updates_.size()); }
  int64_t score_count() const { return static_cast<int64_t>(scores_.size()); }
  float last_global_loss() const { return last_global_loss_; }
  const LedgerConfig& config() const { return cfg_; }
  std::vector<std::string> committee() const;

  // --- certified snapshots (ledger/snapshot.py defines the layout) ---
  // Canonical bytes of the CURRENT protocol state — byte-identical to
  // PyLedger.encode_state (differential-tested), so replicas on either
  // backend derive the same state digest from the same history.  The
  // snapshot op (opcode 9) embeds sha256(encode_state()); applying it
  // re-derives the digest locally, which is what makes a BFT quorum's
  // co-signature an independent proof of the snapshot's correctness.
  std::vector<uint8_t> encode_state() const;
  Digest state_digest() const;

  // --- hash-chained op log ---
  size_t log_size() const { return log_.size(); }
  Digest log_head() const;
  bool verify_log() const;
  const std::vector<std::vector<uint8_t>>& log_ops() const { return ops_; }
  // Deterministic replay: apply a serialized op to this ledger. Returns the
  // status the op produced (replicas must observe the same).
  Status apply_serialized(const std::vector<uint8_t>& op);

  // --- write-ahead log (durable op streaming) ---
  // Attach a WAL file: existing accepted ops are written out, then every
  // subsequently accepted op is appended and flushed before the mutation
  // returns.  PROCESS-crash durability: a crash mid-append leaves at most
  // one torn trailing record, which recovery skips.  (fflush reaches the OS
  // page cache, not the platter — power-loss durability would need fsync
  // per record, a policy left to deployments that need it.)  A write
  // failure (ENOSPC/EIO) detaches the WAL; poll wal_attached() to notice.
  bool attach_wal(const std::string& path);
  void detach_wal();
  bool wal_attached() const { return wal_ != nullptr; }
  ~CommitteeLedger();
  CommitteeLedger(const CommitteeLedger&) = delete;      // owns a FILE*
  CommitteeLedger& operator=(const CommitteeLedger&) = delete;

 private:
  void append_log(const std::vector<uint8_t>& op);
  void maybe_start(const std::string& addr);
  void finish_scoring();

  LedgerConfig cfg_;
  int64_t epoch_;
  Digest global_model_hash_{};             // zero digest at genesis (.cpp:329)
  float last_global_loss_ = 0.f;
  // registration order is the spec'd genesis-committee order
  std::vector<std::string> registration_order_;
  std::unordered_map<std::string, Role> roles_;
  std::vector<UpdateRecord> updates_;              // slot-indexed, arrival order
  std::unordered_map<std::string, size_t> update_slot_;  // sender -> slot
  std::map<std::string, std::vector<float>> scores_;     // scorer -> slot scores
  std::optional<PendingAggregate> pending_;
  bool closed_ = false;                            // round closed early
  int64_t generation_ = 0;                         // writer fence
  int64_t writer_index_ = 0;                       // current writer's slot

  std::vector<std::vector<uint8_t>> ops_;  // serialized accepted mutations
  std::vector<Digest> log_;                // chained digests, log_[i] covers ops_[0..i]
  std::FILE* wal_ = nullptr;               // durable op stream (optional)
};

}  // namespace bflc
