// C ABI for ctypes. pybind11 is not in the image; the surface is kept flat
// (ints, floats, char*, uint8_t[32]) so ctypes bindings stay trivial.
#include <cstring>
#include <string>
#include <vector>

#include "ledger.h"
#include "sha256.h"

using bflc::CommitteeLedger;
using bflc::Digest;
using bflc::LedgerConfig;
using bflc::Role;
using bflc::Status;

extern "C" {

void* bflc_ledger_new(int64_t client_num, int64_t comm_count,
                      int64_t aggregate_count, int64_t needed_update_count,
                      int64_t genesis_epoch) {
  LedgerConfig cfg;
  cfg.client_num = client_num;
  cfg.comm_count = comm_count;
  cfg.aggregate_count = aggregate_count;
  cfg.needed_update_count = needed_update_count;
  cfg.genesis_epoch = genesis_epoch;
  return new CommitteeLedger(cfg);
}

void bflc_ledger_free(void* h) { delete static_cast<CommitteeLedger*>(h); }

int32_t bflc_register_node(void* h, const char* addr) {
  return int32_t(static_cast<CommitteeLedger*>(h)->register_node(addr));
}

void bflc_query_state(void* h, const char* addr, int32_t* role,
                      int64_t* epoch) {
  Role r;
  static_cast<CommitteeLedger*>(h)->query_state(addr, &r, epoch);
  *role = int32_t(r);
}

void bflc_query_global_model(void* h, uint8_t* hash32, int64_t* epoch) {
  Digest d;
  static_cast<CommitteeLedger*>(h)->query_global_model(&d, epoch);
  std::memcpy(hash32, d.data(), 32);
}

int32_t bflc_upload_local_update(void* h, const char* sender,
                                 const uint8_t* payload_hash32,
                                 int64_t n_samples, float avg_cost,
                                 int64_t epoch) {
  Digest d;
  std::memcpy(d.data(), payload_hash32, 32);
  return int32_t(static_cast<CommitteeLedger*>(h)->upload_local_update(
      sender, d, n_samples, avg_cost, epoch));
}

int32_t bflc_upload_scores(void* h, const char* sender, int64_t epoch,
                           const float* scores, int64_t len) {
  return int32_t(static_cast<CommitteeLedger*>(h)->upload_scores(
      sender, epoch, scores, size_t(len)));
}

// Returns update_count if the round is full (>= needed_update_count), else 0 —
// the QueryAllUpdates gate (.cpp:304-311).  Slot i fields are written into the
// parallel output arrays; sender strings are copied into addr_buf at stride
// addr_cap (truncated + NUL-terminated).
int64_t bflc_query_all_updates(void* h, char* addr_buf, int64_t addr_cap,
                               uint8_t* hashes32, int64_t* n_samples,
                               float* avg_costs) {
  auto ups = static_cast<CommitteeLedger*>(h)->query_all_updates();
  for (size_t i = 0; i < ups.size(); ++i) {
    if (addr_buf && addr_cap > 0) {
      std::strncpy(addr_buf + i * size_t(addr_cap), ups[i].sender.c_str(),
                   size_t(addr_cap) - 1);
      addr_buf[i * size_t(addr_cap) + size_t(addr_cap) - 1] = '\0';
    }
    if (hashes32) std::memcpy(hashes32 + 32 * i, ups[i].payload_hash.data(), 32);
    if (n_samples) n_samples[i] = ups[i].n_samples;
    if (avg_costs) avg_costs[i] = ups[i].avg_cost;
  }
  return int64_t(ups.size());
}

int32_t bflc_aggregate_ready(void* h) {
  return static_cast<CommitteeLedger*>(h)->aggregate_ready() ? 1 : 0;
}

// Pending aggregation outcome; returns slot count or -1 if not ready.
int64_t bflc_pending(void* h, float* medians, int32_t* order,
                     int32_t* selected, float* global_loss) {
  const auto* p = static_cast<CommitteeLedger*>(h)->pending();
  if (!p) return -1;
  size_t k = p->medians.size();
  if (medians) std::memcpy(medians, p->medians.data(), k * sizeof(float));
  if (order) std::memcpy(order, p->order.data(), k * sizeof(int32_t));
  if (selected)
    std::memcpy(selected, p->selected.data(),
                p->selected.size() * sizeof(int32_t));
  if (global_loss) *global_loss = p->global_loss;
  return int64_t(k);
}

int64_t bflc_pending_selected_count(void* h) {
  const auto* p = static_cast<CommitteeLedger*>(h)->pending();
  return p ? int64_t(p->selected.size()) : -1;
}

int32_t bflc_close_round(void* h) {
  return int32_t(static_cast<CommitteeLedger*>(h)->close_round());
}

int32_t bflc_force_aggregate(void* h) {
  return int32_t(static_cast<CommitteeLedger*>(h)->force_aggregate());
}

int32_t bflc_round_closed(void* h) {
  return static_cast<CommitteeLedger*>(h)->round_closed() ? 1 : 0;
}

int32_t bflc_promote_writer(void* h, int64_t generation,
                            int64_t writer_index) {
  return int32_t(static_cast<CommitteeLedger*>(h)->promote_writer(
      generation, writer_index));
}

int64_t bflc_generation(void* h) {
  return static_cast<CommitteeLedger*>(h)->generation();
}

int64_t bflc_writer_index(void* h) {
  return static_cast<CommitteeLedger*>(h)->writer_index();
}

// addrs as a comma-joined list (addresses are hex strings, comma-free)
int32_t bflc_reseat_committee(void* h, const char* addrs_csv) {
  std::vector<std::string> addrs;
  std::string cur;
  for (const char* p = addrs_csv; *p; ++p) {
    if (*p == ',') {
      if (!cur.empty()) addrs.push_back(cur);
      cur.clear();
    } else {
      cur.push_back(*p);
    }
  }
  if (!cur.empty()) addrs.push_back(cur);
  return int32_t(static_cast<CommitteeLedger*>(h)->reseat_committee(addrs));
}

int32_t bflc_commit_model(void* h, const uint8_t* hash32, int64_t epoch) {
  Digest d;
  std::memcpy(d.data(), hash32, 32);
  return int32_t(static_cast<CommitteeLedger*>(h)->commit_model(d, epoch));
}

int64_t bflc_epoch(void* h) { return static_cast<CommitteeLedger*>(h)->epoch(); }
int64_t bflc_num_registered(void* h) {
  return static_cast<CommitteeLedger*>(h)->num_registered();
}
int64_t bflc_update_count(void* h) {
  return static_cast<CommitteeLedger*>(h)->update_count();
}
int64_t bflc_score_count(void* h) {
  return static_cast<CommitteeLedger*>(h)->score_count();
}
float bflc_last_global_loss(void* h) {
  return static_cast<CommitteeLedger*>(h)->last_global_loss();
}

// Writes at most max_entries sender strings; returns the true committee size
// (callers re-call with a larger buffer if it exceeds their allocation).
int64_t bflc_committee(void* h, char* addr_buf, int64_t addr_cap,
                       int64_t max_entries) {
  auto comm = static_cast<CommitteeLedger*>(h)->committee();
  size_t n = comm.size();
  if (max_entries >= 0 && size_t(max_entries) < n) n = size_t(max_entries);
  for (size_t i = 0; i < n; ++i) {
    if (addr_buf && addr_cap > 0) {
      std::strncpy(addr_buf + i * size_t(addr_cap), comm[i].c_str(),
                   size_t(addr_cap) - 1);
      addr_buf[i * size_t(addr_cap) + size_t(addr_cap) - 1] = '\0';
    }
  }
  return int64_t(comm.size());
}

// --- op log ---
int64_t bflc_log_size(void* h) {
  return int64_t(static_cast<CommitteeLedger*>(h)->log_size());
}

void bflc_log_head(void* h, uint8_t* out32) {
  Digest d = static_cast<CommitteeLedger*>(h)->log_head();
  std::memcpy(out32, d.data(), 32);
}

int32_t bflc_verify_log(void* h) {
  return static_cast<CommitteeLedger*>(h)->verify_log() ? 1 : 0;
}

int64_t bflc_log_op_size(void* h, int64_t i) {
  const auto& ops = static_cast<CommitteeLedger*>(h)->log_ops();
  if (i < 0 || size_t(i) >= ops.size()) return -1;
  return int64_t(ops[size_t(i)].size());
}

int32_t bflc_log_op(void* h, int64_t i, uint8_t* buf, int64_t cap) {
  const auto& ops = static_cast<CommitteeLedger*>(h)->log_ops();
  if (i < 0 || size_t(i) >= ops.size()) return int32_t(Status::BAD_ARG);
  const auto& op = ops[size_t(i)];
  if (int64_t(op.size()) > cap) return int32_t(Status::BAD_ARG);
  std::memcpy(buf, op.data(), op.size());
  return 0;
}

int32_t bflc_apply_op(void* h, const uint8_t* buf, int64_t len) {
  std::vector<uint8_t> op(buf, buf + len);
  return int32_t(static_cast<CommitteeLedger*>(h)->apply_serialized(op));
}

// --- write-ahead log ---
int32_t bflc_attach_wal(void* h, const char* path) {
  return static_cast<CommitteeLedger*>(h)->attach_wal(path) ? 0 : -1;
}

void bflc_detach_wal(void* h) {
  static_cast<CommitteeLedger*>(h)->detach_wal();
}

// Replay a WAL file into the ledger.  Returns the number of ops applied, or
// -1 on open/magic failure.  A torn trailing record (crash mid-append) is
// skipped; an op the state machine rejects stops replay (corrupt file).
int64_t bflc_replay_wal(void* h, const char* path) {
  std::FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  char magic[8];
  if (std::fread(magic, 1, 8, f) != 8 ||
      std::memcmp(magic, "BFLCWAL1", 8) != 0) {
    std::fclose(f);
    return -1;
  }
  int64_t applied = 0;
  auto* led = static_cast<CommitteeLedger*>(h);
  for (;;) {
    uint8_t hdr[8];
    if (std::fread(hdr, 1, 8, f) != 8) break;        // clean EOF / torn size
    uint64_t n = 0;
    for (int i = 0; i < 8; ++i) n |= uint64_t(hdr[i]) << (8 * i);
    if (n > (1u << 26)) break;                       // implausible: corrupt
    std::vector<uint8_t> op(n);
    if (std::fread(op.data(), 1, n, f) != n) break;  // torn record: stop
    if (led->apply_serialized(op) != Status::OK) {
      std::fclose(f);
      return -(applied + 2);   // signal rejection point (negative, != -1)
    }
    ++applied;
  }
  std::fclose(f);
  return applied;
}

// --- certified snapshots (ledger/snapshot.py) ---
// Canonical state bytes: returns the size; copies into buf when cap is
// large enough (call with cap=0 to size the buffer first).
int64_t bflc_encode_state(void* h, uint8_t* buf, int64_t cap) {
  auto state = static_cast<CommitteeLedger*>(h)->encode_state();
  if (buf && int64_t(state.size()) <= cap)
    std::memcpy(buf, state.data(), state.size());
  return int64_t(state.size());
}

void bflc_state_digest(void* h, uint8_t* out32) {
  Digest d = static_cast<CommitteeLedger*>(h)->state_digest();
  std::memcpy(out32, d.data(), 32);
}

// stand-alone SHA-256 so Python and C++ agree on payload hashing
void bflc_sha256(const uint8_t* data, int64_t len, uint8_t* out32) {
  Digest d = bflc::Sha256::hash(data, size_t(len));
  std::memcpy(out32, d.data(), 32);
}

}  // extern "C"
