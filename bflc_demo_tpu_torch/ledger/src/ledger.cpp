#include "ledger.h"

#include <algorithm>
#include <cmath>
#include <cstring>

namespace bflc {

namespace {

// op codes for the serialized log
enum OpCode : uint8_t { OP_REGISTER = 1, OP_UPLOAD = 2, OP_SCORES = 3,
                        OP_COMMIT = 4, OP_CLOSE = 5, OP_FORCE = 6,
                        OP_RESEAT = 7, OP_PROMOTE = 8, OP_SNAPSHOT = 9 };

constexpr char kStateMagic[] = "BFLCSNST1";  // 9 bytes, no terminator use

void put_i64(std::vector<uint8_t>& b, int64_t v) {
  for (int i = 0; i < 8; ++i) b.push_back(uint8_t(uint64_t(v) >> (8 * i)));
}
void put_f32(std::vector<uint8_t>& b, float v) {
  uint8_t raw[4];
  std::memcpy(raw, &v, 4);
  b.insert(b.end(), raw, raw + 4);
}
void put_str(std::vector<uint8_t>& b, const std::string& s) {
  put_i64(b, int64_t(s.size()));
  b.insert(b.end(), s.begin(), s.end());
}
void put_digest(std::vector<uint8_t>& b, const Digest& d) {
  b.insert(b.end(), d.begin(), d.end());
}

struct Reader {
  const uint8_t* p;
  const uint8_t* end;
  bool ok = true;
  int64_t i64() {
    if (end - p < 8) { ok = false; return 0; }
    uint64_t v = 0;
    for (int i = 0; i < 8; ++i) v |= uint64_t(p[i]) << (8 * i);
    p += 8;
    return int64_t(v);
  }
  float f32() {
    if (end - p < 4) { ok = false; return 0.f; }
    float v;
    std::memcpy(&v, p, 4);
    p += 4;
    return v;
  }
  std::string str() {
    int64_t n = i64();
    if (!ok || n < 0 || end - p < n) { ok = false; return {}; }
    std::string s(reinterpret_cast<const char*>(p), size_t(n));
    p += n;
    return s;
  }
  Digest digest() {
    Digest d{};
    if (end - p < 32) { ok = false; return d; }
    std::memcpy(d.data(), p, 32);
    p += 32;
    return d;
  }
};

// total order on update slots: median desc, slot asc (SPEC'd determinism
// replacing the reference's unordered sort, .cpp:118-120 / 365-366)
std::vector<int32_t> rank_slots(const std::vector<float>& medians) {
  std::vector<int32_t> order(medians.size());
  for (size_t i = 0; i < order.size(); ++i) order[i] = int32_t(i);
  std::stable_sort(order.begin(), order.end(), [&](int32_t a, int32_t b) {
    if (medians[a] != medians[b]) return medians[a] > medians[b];
    return a < b;
  });
  return order;
}

float median_of(std::vector<float> v) {
  // intended GetMid semantics: true median, mean of middles for even n
  // (.cpp:81-115; quirk documented in SURVEY.md §3.4)
  std::sort(v.begin(), v.end());
  size_t n = v.size();
  if (n == 0) return 0.f;
  return 0.5f * (v[(n - 1) / 2] + v[n / 2]);
}

}  // namespace

namespace {
constexpr char kWalMagic[] = "BFLCWAL1";     // 8 bytes incl. no terminator use
}

CommitteeLedger::CommitteeLedger(const LedgerConfig& cfg)
    : cfg_(cfg), epoch_(cfg.genesis_epoch) {}

CommitteeLedger::~CommitteeLedger() { detach_wal(); }

static bool wal_write_record(std::FILE* f, const std::vector<uint8_t>& op,
                             bool flush) {
  uint8_t hdr[8];
  uint64_t n = op.size();
  for (int i = 0; i < 8; ++i) hdr[i] = uint8_t(n >> (8 * i));
  if (std::fwrite(hdr, 1, 8, f) != 8) return false;
  if (std::fwrite(op.data(), 1, op.size(), f) != op.size()) return false;
  if (flush && std::fflush(f) != 0) return false;
  return true;
}

bool CommitteeLedger::attach_wal(const std::string& path) {
  detach_wal();
  std::FILE* f = std::fopen(path.c_str(), "wb");
  if (!f) return false;
  // snapshot the accepted history with ONE flush at the end
  bool ok = std::fwrite(kWalMagic, 1, 8, f) == 8;
  for (const auto& op : ops_) {
    if (!ok) break;
    ok = wal_write_record(f, op, /*flush=*/false);
  }
  if (!ok || std::fflush(f) != 0) {
    std::fclose(f);
    return false;
  }
  wal_ = f;
  return true;
}

void CommitteeLedger::detach_wal() {
  if (wal_) {
    std::fclose(wal_);
    wal_ = nullptr;
  }
}

void CommitteeLedger::append_log(const std::vector<uint8_t>& op) {
  Sha256 h;
  if (!log_.empty()) h.update(log_.back().data(), log_.back().size());
  h.update(op.data(), op.size());
  ops_.push_back(op);
  log_.push_back(h.finish());
  // durability point: the op reaches the WAL before the call returns.
  // A write failure (ENOSPC, EIO) detaches the WAL so wal_attached() flips
  // false — the in-memory state machine keeps serving, observably
  // un-journaled, rather than silently losing records.
  if (wal_ && !wal_write_record(wal_, op, /*flush=*/true)) detach_wal();
}

Digest CommitteeLedger::log_head() const {
  return log_.empty() ? Digest{} : log_.back();
}

bool CommitteeLedger::verify_log() const {
  Digest prev{};
  for (size_t i = 0; i < ops_.size(); ++i) {
    Sha256 h;
    if (i > 0) h.update(prev.data(), prev.size());
    h.update(ops_[i].data(), ops_[i].size());
    prev = h.finish();
    if (prev != log_[i]) return false;
  }
  return true;
}

void CommitteeLedger::maybe_start(const std::string&) {
  // FL start trigger: CLIENT_NUM registrations seat the genesis committee and
  // zero the epoch (.cpp:175-186).  Committee = first comm_count registrants
  // in arrival order (spec'd; the reference uses map iteration order).
  if (int64_t(registration_order_.size()) == cfg_.client_num &&
      epoch_ == cfg_.genesis_epoch) {
    for (int64_t i = 0; i < cfg_.comm_count; ++i) {
      roles_[registration_order_[size_t(i)]] = Role::COMMITTEE;
    }
    epoch_ = 0;
  }
}

Status CommitteeLedger::register_node(const std::string& addr) {
  if (addr.empty()) return Status::BAD_ARG;
  if (roles_.count(addr)) return Status::ALREADY_REGISTERED;
  roles_[addr] = Role::TRAINER;
  registration_order_.push_back(addr);
  std::vector<uint8_t> op{OP_REGISTER};
  put_str(op, addr);
  append_log(op);
  maybe_start(addr);
  return Status::OK;
}

void CommitteeLedger::query_state(const std::string& addr, Role* role,
                                  int64_t* epoch) const {
  auto it = roles_.find(addr);
  // unknown address reads as trainer without persisting (.cpp:191-205)
  *role = (it == roles_.end()) ? Role::TRAINER : it->second;
  *epoch = epoch_;
}

void CommitteeLedger::query_global_model(Digest* model_hash,
                                         int64_t* epoch) const {
  *model_hash = global_model_hash_;
  *epoch = epoch_;
}

Status CommitteeLedger::upload_local_update(const std::string& sender,
                                            const Digest& payload,
                                            int64_t n_samples, float avg_cost,
                                            int64_t epoch) {
  if (sender.empty() || n_samples <= 0) return Status::BAD_ARG;
  if (epoch_ == cfg_.genesis_epoch) return Status::NOT_STARTED;
  if (epoch != epoch_) return Status::WRONG_EPOCH;          // .cpp:225-226
  if (update_slot_.count(sender)) return Status::DUPLICATE;  // .cpp:232-233
  // The update set freezes once scoring can begin: score rows are sized to
  // the update count at upload time, so a late update after close_round()
  // (or after any score row landed) would desynchronize row lengths and
  // corrupt the medians.  No reference equivalent — the contract can't close
  // a round early, so its update set only grows before scoring.
  // Compat note: a WAL written by pre-guard code that logged such an op now
  // stops replay at it with a clean rejection.  That log was already
  // poisoned — replaying it reproduced the out-of-bounds corruption — so
  // failing loudly at the exact op is the recovery improvement, not a
  // format break.
  if (closed_ || !scores_.empty()) return Status::CAP_REACHED;
  if (int64_t(updates_.size()) >= cfg_.needed_update_count)
    return Status::CAP_REACHED;                              // .cpp:239-244
  // parity note: like the contract, no role check here — the reference never
  // rejects a committee member's upload; clients just don't send them.
  update_slot_[sender] = updates_.size();
  updates_.push_back(UpdateRecord{sender, payload, n_samples, avg_cost});
  std::vector<uint8_t> op{OP_UPLOAD};
  put_str(op, sender);
  put_digest(op, payload);
  put_i64(op, n_samples);
  put_f32(op, avg_cost);
  put_i64(op, epoch);
  append_log(op);
  return Status::OK;
}

Status CommitteeLedger::upload_scores(const std::string& sender, int64_t epoch,
                                      const float* scores, size_t len) {
  if (sender.empty() || scores == nullptr) return Status::BAD_ARG;
  if (epoch_ == cfg_.genesis_epoch) return Status::NOT_STARTED;
  if (epoch != epoch_) return Status::WRONG_EPOCH;          // .cpp:266-269
  auto it = roles_.find(sender);
  if (it == roles_.end() || it->second != Role::COMMITTEE)
    return Status::NOT_COMMITTEE;                            // .cpp:272-275
  if (len != updates_.size()) return Status::BAD_ARG;
  // Non-finite scores never enter the log: NaN breaks the strict weak
  // ordering of the median/ranking sorts (UB) and NaN ordering diverges
  // between backends, so a Byzantine scorer could fork the replicas.
  for (size_t i = 0; i < len; ++i)
    if (!std::isfinite(scores[i])) return Status::BAD_ARG;
  if (int64_t(updates_.size()) < cfg_.needed_update_count && !closed_)
    return Status::NOT_READY;  // scoring starts once the round is full
  // once the committee is complete the outcome is frozen until commit — a
  // late re-score must not mutate the selection the compute plane is applying
  if (pending_) return Status::NOT_READY;
  // re-upload replaces; score_count never double-counts (spec'd divergence
  // from the unconditional ++ at .cpp:285-289)
  scores_[sender] = std::vector<float>(scores, scores + len);
  std::vector<uint8_t> op{OP_SCORES};
  put_str(op, sender);
  put_i64(op, epoch);
  put_i64(op, int64_t(len));
  for (size_t i = 0; i < len; ++i) put_f32(op, scores[i]);
  append_log(op);
  // fire when every CURRENT committee member's row is in (committee size
  // equals comm_count normally; smaller after a partial-round election or a
  // mid-round reseat — former members' rows stay in the pool but don't
  // gate completion)
  int64_t comm_now = 0, present = 0;
  for (const auto& kv : roles_)
    if (kv.second == Role::COMMITTEE) ++comm_now;
  for (const auto& kv : scores_) {
    auto it = roles_.find(kv.first);
    if (it != roles_.end() && it->second == Role::COMMITTEE) ++present;
  }
  if (present == comm_now && comm_now > 0) finish_scoring();
  return Status::OK;
}

void CommitteeLedger::finish_scoring() {
  // median per slot across committee rows (.cpp:351-362), rank (.cpp:365-366),
  // top-k select (.cpp:369-376), loss (.cpp:416-425)
  PendingAggregate p;
  size_t k = updates_.size();
  p.medians.resize(k);
  for (size_t s = 0; s < k; ++s) {
    std::vector<float> col;
    col.reserve(scores_.size());
    // rows are length-checked at upload and the update set freezes once
    // scoring begins, so every row has length k; skip any that don't
    // (defense in depth — never index past a row's end)
    for (const auto& kv : scores_)
      if (kv.second.size() == k) col.push_back(kv.second[s]);
    p.medians[s] = median_of(std::move(col));
  }
  p.order = rank_slots(p.medians);
  int64_t take = std::min<int64_t>(cfg_.aggregate_count, int64_t(k));
  p.selected.assign(p.order.begin(), p.order.begin() + take);
  float loss = 0.f;
  for (int32_t s : p.selected) loss += updates_[size_t(s)].avg_cost;
  p.global_loss = take > 0 ? loss / float(take) : 0.f;
  pending_ = std::move(p);
}

std::vector<UpdateRecord> CommitteeLedger::query_all_updates() const {
  if (int64_t(updates_.size()) < cfg_.needed_update_count && !closed_)
    return {};
  return updates_;  // gate per .cpp:304-311 (or round closed early)
}

Status CommitteeLedger::close_round() {
  if (epoch_ == cfg_.genesis_epoch) return Status::NOT_STARTED;
  if (closed_ || pending_) return Status::NOT_READY;
  if (int64_t(updates_.size()) >= cfg_.needed_update_count)
    return Status::NOT_READY;          // full rounds don't need closing
  if (updates_.empty()) return Status::NOT_READY;
  closed_ = true;
  std::vector<uint8_t> op{OP_CLOSE};
  put_i64(op, epoch_);
  append_log(op);
  return Status::OK;
}

Status CommitteeLedger::reseat_committee(
    const std::vector<std::string>& addrs) {
  if (epoch_ == cfg_.genesis_epoch) return Status::NOT_STARTED;
  if (pending_) return Status::NOT_READY;
  if (addrs.empty() || int64_t(addrs.size()) > cfg_.comm_count)
    return Status::BAD_ARG;
  for (const auto& a : addrs)
    if (!roles_.count(a)) return Status::BAD_ARG;
  for (auto& kv : roles_) kv.second = Role::TRAINER;
  for (const auto& a : addrs) roles_[a] = Role::COMMITTEE;
  std::vector<uint8_t> op{OP_RESEAT};
  put_i64(op, epoch_);
  put_i64(op, int64_t(addrs.size()));
  for (const auto& a : addrs) put_str(op, a);
  append_log(op);
  // rows already present may now complete the (new, possibly smaller)
  // committee — check the firing condition immediately
  int64_t comm_now = int64_t(addrs.size());
  int64_t present = 0;
  for (const auto& kv : scores_) {
    auto it = roles_.find(kv.first);
    if (it != roles_.end() && it->second == Role::COMMITTEE) ++present;
  }
  if (present == comm_now && present > 0) finish_scoring();
  return Status::OK;
}

Status CommitteeLedger::force_aggregate() {
  if (epoch_ == cfg_.genesis_epoch) return Status::NOT_STARTED;
  if (pending_) return Status::NOT_READY;
  if (scores_.empty()) return Status::NOT_READY;
  std::vector<uint8_t> op{OP_FORCE};
  put_i64(op, epoch_);
  append_log(op);
  finish_scoring();
  return Status::OK;
}

Status CommitteeLedger::promote_writer(int64_t generation,
                                       int64_t writer_index) {
  // strictly one step per promotion: replicas replaying the op stream and
  // WAL recovery both re-derive the same fence sequence; a skipped or
  // repeated generation is a protocol violation, not a race to tolerate
  if (generation != generation_ + 1) return Status::BAD_ARG;
  if (writer_index < 0) return Status::BAD_ARG;
  generation_ = generation;
  writer_index_ = writer_index;
  std::vector<uint8_t> op{OP_PROMOTE};
  put_i64(op, generation);
  put_i64(op, writer_index);
  append_log(op);
  return Status::OK;
}

Status CommitteeLedger::commit_model(const Digest& new_model_hash,
                                     int64_t epoch) {
  if (!pending_) return Status::NOT_READY;
  if (epoch != epoch_) return Status::WRONG_EPOCH;
  global_model_hash_ = new_model_hash;
  last_global_loss_ = pending_->global_loss;
  // committee re-election (.cpp:443-455): every committee member reverts to
  // trainer, the top-comm_count scored uploaders take over.
  for (auto& kv : roles_) kv.second = Role::TRAINER;
  int64_t seated = 0;
  for (int32_t s : pending_->order) {
    if (seated == cfg_.comm_count) break;
    roles_[updates_[size_t(s)].sender] = Role::COMMITTEE;
    ++seated;
  }
  // round reset (.cpp:427-441) + epoch advance (.cpp:416-421)
  updates_.clear();
  update_slot_.clear();
  scores_.clear();
  pending_.reset();
  closed_ = false;
  epoch_ += 1;
  std::vector<uint8_t> op{OP_COMMIT};
  put_digest(op, new_model_hash);
  put_i64(op, epoch);
  append_log(op);
  return Status::OK;
}

std::vector<uint8_t> CommitteeLedger::encode_state() const {
  // canonical state bytes — must match ledger/snapshot.py
  // encode_state_dict field for field (differential-tested in
  // tests/test_snapshot.py).  Score rows iterate std::map order ==
  // bytewise string order == Python sorted() for ASCII addresses.
  std::vector<uint8_t> b(kStateMagic, kStateMagic + 9);
  put_i64(b, epoch_);
  put_digest(b, global_model_hash_);
  put_f32(b, last_global_loss_);
  put_i64(b, generation_);
  put_i64(b, writer_index_);
  b.push_back(closed_ ? 1 : 0);
  put_i64(b, int64_t(registration_order_.size()));
  for (const auto& addr : registration_order_) {
    put_str(b, addr);
    auto it = roles_.find(addr);
    b.push_back(it != roles_.end() && it->second == Role::COMMITTEE ? 1
                                                                    : 0);
  }
  put_i64(b, int64_t(updates_.size()));
  for (const auto& u : updates_) {
    put_str(b, u.sender);
    put_digest(b, u.payload_hash);
    put_i64(b, u.n_samples);
    put_f32(b, u.avg_cost);
  }
  put_i64(b, int64_t(scores_.size()));
  for (const auto& kv : scores_) {
    put_str(b, kv.first);
    put_i64(b, int64_t(kv.second.size()));
    for (float v : kv.second) put_f32(b, v);
  }
  if (!pending_) {
    b.push_back(0);
  } else {
    b.push_back(1);
    put_i64(b, int64_t(pending_->medians.size()));
    for (float v : pending_->medians) put_f32(b, v);
    put_i64(b, int64_t(pending_->order.size()));
    for (int32_t s : pending_->order) {
      for (int i = 0; i < 4; ++i)
        b.push_back(uint8_t(uint32_t(s) >> (8 * i)));
    }
    put_i64(b, int64_t(pending_->selected.size()));
    for (int32_t s : pending_->selected) {
      for (int i = 0; i < 4; ++i)
        b.push_back(uint8_t(uint32_t(s) >> (8 * i)));
    }
    put_f32(b, pending_->global_loss);
  }
  return b;
}

Digest CommitteeLedger::state_digest() const {
  auto state = encode_state();
  Sha256 h;
  h.update(state.data(), state.size());
  return h.finish();
}

std::vector<std::string> CommitteeLedger::committee() const {
  std::vector<std::string> out;
  for (const auto& addr : registration_order_) {
    auto it = roles_.find(addr);
    if (it != roles_.end() && it->second == Role::COMMITTEE)
      out.push_back(addr);
  }
  return out;
}

Status CommitteeLedger::apply_serialized(const std::vector<uint8_t>& op) {
  if (op.empty()) return Status::BAD_ARG;
  Reader r{op.data() + 1, op.data() + op.size()};
  switch (op[0]) {
    case OP_REGISTER: {
      std::string addr = r.str();
      if (!r.ok) return Status::BAD_ARG;
      return register_node(addr);
    }
    case OP_UPLOAD: {
      std::string sender = r.str();
      Digest d = r.digest();
      int64_t n = r.i64();
      float c = r.f32();
      int64_t ep = r.i64();
      if (!r.ok) return Status::BAD_ARG;
      return upload_local_update(sender, d, n, c, ep);
    }
    case OP_SCORES: {
      std::string sender = r.str();
      int64_t ep = r.i64();
      int64_t len = r.i64();
      // bound len by the bytes actually present (4 per score) BEFORE
      // allocating — a corrupt/hostile op could claim an exabyte here
      if (!r.ok || len < 0 || len > (r.end - r.p) / 4) return Status::BAD_ARG;
      std::vector<float> sc(static_cast<size_t>(len));
      for (auto& v : sc) v = r.f32();
      if (!r.ok) return Status::BAD_ARG;
      return upload_scores(sender, ep, sc.data(), sc.size());
    }
    case OP_COMMIT: {
      Digest d = r.digest();
      int64_t ep = r.i64();
      if (!r.ok) return Status::BAD_ARG;
      return commit_model(d, ep);
    }
    case OP_CLOSE: {
      int64_t ep = r.i64();
      if (!r.ok || ep != epoch_) return Status::BAD_ARG;
      return close_round();
    }
    case OP_FORCE: {
      int64_t ep = r.i64();
      if (!r.ok || ep != epoch_) return Status::BAD_ARG;
      return force_aggregate();
    }
    case OP_PROMOTE: {
      int64_t gen = r.i64();
      int64_t idx = r.i64();
      if (!r.ok) return Status::BAD_ARG;
      return promote_writer(gen, idx);
    }
    case OP_SNAPSHOT: {
      // certified checkpoint marker: the digest is RE-DERIVED from this
      // replica's own state — a corrupt or lying snapshot refuses here,
      // which is exactly what makes a quorum co-signature on this op an
      // independent proof of the checkpoint (ledger/snapshot.py)
      int64_t ep = r.i64();
      Digest claimed = r.digest();
      if (!r.ok || r.p != r.end) return Status::BAD_ARG;
      if (ep != epoch_ || claimed != state_digest()) return Status::BAD_ARG;
      append_log(op);
      return Status::OK;
    }
    case OP_RESEAT: {
      int64_t ep = r.i64();
      int64_t n = r.i64();
      // every address needs at least its 8-byte length prefix, so n is
      // bounded by the remaining bytes — check BEFORE looping
      if (!r.ok || ep != epoch_ || n <= 0 || n > (r.end - r.p) / 8)
        return Status::BAD_ARG;
      std::vector<std::string> addrs;
      for (int64_t i = 0; i < n && r.ok; ++i) addrs.push_back(r.str());
      if (!r.ok) return Status::BAD_ARG;
      return reseat_committee(addrs);
    }
    default:
      return Status::BAD_ARG;
  }
}

}  // namespace bflc
