// Native host-side batching runtime: paged KV-cache block bookkeeping and
// the continuous-batching slot scheduler (the port's copy of the JAX
// package's native/batch_runtime.cc, the same source).
//
// The serving manager (runtime/batch_manager.py) runs its device work in
// PyTorch on the card; this library owns the per-tick host bookkeeping:
// block refcounts, beam sharing and copy-on-write, slot lifecycle, stop
// decisions, called through ctypes (native/batch_runtime.py) with no
// per-token Python allocation.
//
// Semantics are kept identical to the Python versions
// (runtime/kv_cache_manager.py, runtime/batch_manager._PyScheduler); the
// tests drive both, and the JAX package's library, on random traces.

#include <cstdint>
#include <cstring>
#include <deque>
#include <unordered_map>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// Paged KV block manager
// ---------------------------------------------------------------------------

struct Block {
  int idx;
  int ref_count = 0;
};

struct BlocksManager {
  int num_blocks;
  int tokens_per_block;
  int beam_width;
  std::vector<Block> blocks;          // stable storage, indexed by block idx
  std::deque<int> free_blocks;        // FIFO, matches python pop(0)/append
  // per sequence: [beam][block list]
  std::unordered_map<int, std::vector<std::vector<int>>> allocated;

  BlocksManager(int nb, int tpb, int bw)
      : num_blocks(nb), tokens_per_block(tpb), beam_width(bw) {
    blocks.resize(nb);
    for (int i = 0; i < nb; ++i) {
      blocks[i].idx = i;
      free_blocks.push_back(i);
    }
  }

  bool has_free() const { return !free_blocks.empty(); }

  // Append one block per beam (or one shared block).  Returns false on
  // pool exhaustion (python raises RuntimeError).
  bool allocate(int owner, bool share_across_beam) {
    auto it = allocated.find(owner);
    if (it == allocated.end())
      it = allocated.emplace(owner,
                             std::vector<std::vector<int>>(beam_width)).first;
    int block = -1;
    for (int bi = 0; bi < beam_width; ++bi) {
      if (!share_across_beam || block < 0) {
        if (free_blocks.empty()) return false;
        block = free_blocks.front();
        free_blocks.pop_front();
      }
      blocks[block].ref_count++;
      it->second[bi].push_back(block);
    }
    return true;
  }

  // Copy-on-write un-share of position block_idx (ref replace_shared_block).
  bool replace_shared(int owner, int block_idx) {
    auto& rows = allocated[owner];
    if (blocks[rows[0][block_idx]].ref_count <= 1) return true;  // not shared
    for (int bi = 0; bi < beam_width; ++bi) {
      int shared = rows[bi][block_idx];
      if (blocks[shared].ref_count > 0) {
        if (--blocks[shared].ref_count == 0) free_blocks.push_back(shared);
      }
      if (free_blocks.empty()) return false;
      int fresh = free_blocks.front();
      free_blocks.pop_front();
      blocks[fresh].ref_count++;
      rows[bi][block_idx] = fresh;
    }
    return true;
  }

  void free_owner(int owner) {
    auto it = allocated.find(owner);
    if (it == allocated.end()) return;
    for (auto& beam_blocks : it->second)
      for (int b : beam_blocks)
        if (--blocks[b].ref_count == 0) free_blocks.push_back(b);
    allocated.erase(it);
  }

  int num_owner_blocks(int owner) { return (int)allocated[owner][0].size(); }
};

struct KVCacheManager {
  BlocksManager bm;
  int tokens_per_block;
  int max_blocks_per_seq;
  int beam_width;
  std::vector<int> seq_ids;   // insertion order
  std::vector<int> lens;

  KVCacheManager(int num_blocks, int tpb, int mbps, int bw)
      : bm(num_blocks, tpb, bw), tokens_per_block(tpb),
        max_blocks_per_seq(mbps), beam_width(bw) {}

  bool add_sequence(int seq_id, int context_len) {
    seq_ids.push_back(seq_id);
    lens.push_back(context_len);
    int context_blocks =
        context_len <= 0 ? 1 : (context_len + tokens_per_block - 1) / tokens_per_block;
    if (context_blocks < 1) context_blocks = 1;
    // full prompt blocks shared across beams (read-only after prefill);
    // a PARTIAL last block is private per beam from the start: generation
    // tokens land in it at every beam's own row (mirror of the python
    // KVCacheManager.add_sequence — the lockstep test drives both)
    bool partial = (context_len % tokens_per_block != 0) || context_len <= 0;
    int full = context_blocks - (partial ? 1 : 0);
    for (int i = 0; i < full; ++i)
      if (!bm.allocate(seq_id, beam_width > 1)) return false;
    if (partial)
      if (!bm.allocate(seq_id, false)) return false;
    return true;
  }

  // finished: uint8[num_seqs] aligned with insertion order
  bool step(const uint8_t* finished) {
    for (size_t i = 0; i < seq_ids.size(); ++i) {
      if (finished[i]) continue;
      int cur = lens[i];
      if (cur % tokens_per_block == 0) {
        if (!bm.allocate(seq_ids[i], false)) return false;
      } else if (beam_width > 1) {
        int last = bm.num_owner_blocks(seq_ids[i]) - 1;
        if (!bm.replace_shared(seq_ids[i], last)) return false;
      }
      lens[i] += 1;
    }
    return true;
  }

  bool stop(int seq_id) {
    bm.free_owner(seq_id);
    for (size_t i = 0; i < seq_ids.size(); ++i)
      if (seq_ids[i] == seq_id) {
        seq_ids.erase(seq_ids.begin() + i);
        lens.erase(lens.begin() + i);
        return true;
      }
    return false;
  }

  // out: int32[num_seqs * beam * max_blocks], -1 padded
  void block_table(int32_t* out) {
    size_t n = seq_ids.size();
    std::memset(out, 0xff, n * beam_width * max_blocks_per_seq * 4);
    for (size_t si = 0; si < n; ++si) {
      auto& rows = bm.allocated[seq_ids[si]];
      for (int bi = 0; bi < beam_width; ++bi)
        for (size_t li = 0; li < rows[bi].size(); ++li)
          out[(si * beam_width + bi) * max_blocks_per_seq + li] = rows[bi][li];
    }
  }
};

// ---------------------------------------------------------------------------
// Continuous-batching slot scheduler
// ---------------------------------------------------------------------------

struct PendingRequest {
  int64_t id;
  int max_new_tokens;
  int end_id;
  uint8_t streaming;
};

struct Scheduler {
  int max_slots;
  int max_seq_len;
  int default_end_id;
  std::deque<PendingRequest> pending;
  // per-slot state
  std::vector<uint8_t> active;
  std::vector<int32_t> lengths;
  std::vector<int32_t> budget;
  std::vector<int32_t> last_token;
  std::vector<int64_t> request_id;
  std::vector<int32_t> end_id;
  std::vector<uint8_t> streaming;
  std::vector<int32_t> n_generated;

  Scheduler(int slots, int seq_len, int eid)
      : max_slots(slots), max_seq_len(seq_len), default_end_id(eid),
        active(slots, 0), lengths(slots, 0), budget(slots, 0),
        last_token(slots, 0), request_id(slots, -1), end_id(slots, eid),
        streaming(slots, 0), n_generated(slots, 0) {}

  void add_request(int64_t id, int max_new, int eid, uint8_t stream) {
    pending.push_back({id, max_new, eid < 0 ? default_end_id : eid, stream});
  }

  // Pop the next pending request into a free slot.  Returns slot >= 0 and
  // fills *rid, or -1 when no request or no free slot.
  int next_admission(int64_t* rid) {
    if (pending.empty()) return -1;
    for (int s = 0; s < max_slots; ++s) {
      if (!active[s]) {
        PendingRequest r = pending.front();
        pending.pop_front();
        active[s] = 1;
        lengths[s] = 0;           // set by on_admitted
        budget[s] = r.max_new_tokens;
        request_id[s] = r.id;
        end_id[s] = r.end_id;
        streaming[s] = r.streaming;
        n_generated[s] = 0;
        *rid = r.id;
        return s;
      }
    }
    return -1;
  }

  void on_admitted(int slot, int prompt_len) { lengths[slot] = prompt_len; }

  // Account one generated token.  Flag bits: 1 = finished, 2 = emit a
  // streaming chunk (matches ContinuousBatchingManager._push_token).
  int push_token(int slot, int tok) {
    budget[slot] -= 1;
    last_token[slot] = tok;
    lengths[slot] += 1;
    n_generated[slot] += 1;
    bool done = tok == end_id[slot] || budget[slot] <= 0 ||
                lengths[slot] >= max_seq_len - 1;
    int flags = 0;
    if (done) {
      flags |= 1;
      active[slot] = 0;
    } else if (streaming[slot]) {
      flags |= 2;
    }
    return flags;
  }
};

}  // namespace

// ---------------------------------------------------------------------------
// C API
// ---------------------------------------------------------------------------

extern "C" {

void* ewt_kv_create(int num_blocks, int tokens_per_block,
                    int max_blocks_per_seq, int beam_width) {
  return new KVCacheManager(num_blocks, tokens_per_block, max_blocks_per_seq,
                            beam_width);
}
void ewt_kv_destroy(void* p) { delete (KVCacheManager*)p; }
int ewt_kv_add_sequence(void* p, int seq_id, int context_len) {
  return ((KVCacheManager*)p)->add_sequence(seq_id, context_len) ? 0 : -1;
}
int ewt_kv_step(void* p, const uint8_t* finished) {
  return ((KVCacheManager*)p)->step(finished) ? 0 : -1;
}
int ewt_kv_stop(void* p, int seq_id) {
  return ((KVCacheManager*)p)->stop(seq_id) ? 0 : -1;
}
int ewt_kv_num_sequences(void* p) {
  return (int)((KVCacheManager*)p)->seq_ids.size();
}
int ewt_kv_free_blocks(void* p) {
  return (int)((KVCacheManager*)p)->bm.free_blocks.size();
}
void ewt_kv_block_table(void* p, int32_t* out) {
  ((KVCacheManager*)p)->block_table(out);
}

void* ewt_sched_create(int max_slots, int max_seq_len, int end_id) {
  return new Scheduler(max_slots, max_seq_len, end_id);
}
void ewt_sched_destroy(void* p) { delete (Scheduler*)p; }
void ewt_sched_add_request(void* p, int64_t id, int max_new_tokens,
                           int end_id, uint8_t streaming) {
  ((Scheduler*)p)->add_request(id, max_new_tokens, end_id, streaming);
}
int ewt_sched_next_admission(void* p, int64_t* request_id) {
  return ((Scheduler*)p)->next_admission(request_id);
}
void ewt_sched_on_admitted(void* p, int slot, int prompt_len) {
  ((Scheduler*)p)->on_admitted(slot, prompt_len);
}
int ewt_sched_push_token(void* p, int slot, int tok) {
  return ((Scheduler*)p)->push_token(slot, tok);
}
int ewt_sched_num_pending(void* p) {
  return (int)((Scheduler*)p)->pending.size();
}
int ewt_sched_num_active(void* p) {
  Scheduler* s = (Scheduler*)p;
  int n = 0;
  for (uint8_t a : s->active) n += a;
  return n;
}
void ewt_sched_state(void* p, uint8_t* active, int32_t* lengths,
                     int32_t* last_tokens) {
  Scheduler* s = (Scheduler*)p;
  std::memcpy(active, s->active.data(), s->max_slots);
  std::memcpy(lengths, s->lengths.data(), s->max_slots * 4);
  std::memcpy(last_tokens, s->last_token.data(), s->max_slots * 4);
}

}  // extern "C"
