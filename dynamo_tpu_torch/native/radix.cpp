// Native radix prefix index — the router's hottest loop in C++.
//
// The port's copy of dynamo_tpu/native/radix.cpp, behaviour unchanged.
// Mirrors dynamo_tpu_torch/router/indexer.py `RadixTree` exactly (which in
// turn mirrors the reference's Rust `lib/llm/src/kv_router/indexer.rs:222`):
// a prefix tree over KV block hashes across (worker, dp_rank), with
// - apply stored/removed/cleared events,
// - find_matches: consecutive-prefix overlap scores per worker,
// - O(1) removal via a seq_hash -> node table, upward pruning,
// - dump as (worker, parent_seq, seq, local) rows for snapshots.
//
// The reference keeps this loop native (Rust) for a reason: at high QPS
// the per-request prefix walk and the event ingest dominate router CPU.
// Exposed as a C ABI for ctypes; equivalence vs the Python tree is
// enforced by randomized differential tests
// (tests/test_torch_native_radix.py).

#include <cstdint>
#include <cstddef>
#include <unordered_map>
#include <unordered_set>
#include <vector>
#include <algorithm>

namespace {

struct WKey {
    uint64_t wid;
    uint32_t dp;
    bool operator==(const WKey& o) const {
        return wid == o.wid && dp == o.dp;
    }
};

struct WKeyHash {
    size_t operator()(const WKey& k) const {
        uint64_t h = k.wid * 0x9e3779b97f4a7c15ULL;
        h ^= (uint64_t)k.dp * 0xc2b2ae3d27d4eb4fULL;
        h ^= h >> 29;
        return (size_t)h;
    }
};

struct Node {
    uint64_t local_hash;
    uint64_t seq_hash;
    Node* parent;
    std::unordered_map<uint64_t, Node*> children;  // local_hash -> node
    std::vector<WKey> workers;                     // small; linear ops

    bool has_worker(const WKey& w) const {
        return std::find(workers.begin(), workers.end(), w) != workers.end();
    }
    void add_worker(const WKey& w) {
        if (!has_worker(w)) workers.push_back(w);
    }
    void drop_worker(const WKey& w) {
        workers.erase(std::remove(workers.begin(), workers.end(), w),
                      workers.end());
    }
};

struct Tree {
    uint64_t seed_hash;
    Node* root;
    std::unordered_map<uint64_t, Node*> by_seq;
    std::unordered_map<WKey, std::unordered_set<uint64_t>, WKeyHash>
        worker_blocks;

    explicit Tree(uint64_t seed) : seed_hash(seed) {
        root = new Node{0, seed, nullptr, {}, {}};
        by_seq.emplace(seed, root);
    }
    ~Tree() { free_subtree(root); }

    void free_subtree(Node* n) {
        for (auto& kv : n->children) free_subtree(kv.second);
        delete n;
    }

    void clear() {
        free_subtree(root);
        by_seq.clear();
        worker_blocks.clear();
        root = new Node{0, seed_hash, nullptr, {}, {}};
        by_seq.emplace(seed_hash, root);
    }

    void prune(Node* node) {
        while (node != root && node->workers.empty() &&
               node->children.empty()) {
            Node* parent = node->parent;
            parent->children.erase(node->local_hash);
            // unconditional, like Python's `_by_seq.pop(seq_hash, None)` —
            // under duplicate seq hashes this may drop a mapping to a
            // NEWER node, and equivalence means mirroring that too
            by_seq.erase(node->seq_hash);
            delete node;
            node = parent;
        }
    }

    void remove_one(const WKey& w, uint64_t seq_hash) {
        auto it = by_seq.find(seq_hash);
        if (it == by_seq.end()) return;  // unknown hash: untouched, like
        Node* node = it->second;         // indexer.py _remove's early out
        node->drop_worker(w);
        auto wb = worker_blocks.find(w);
        if (wb != worker_blocks.end()) wb->second.erase(seq_hash);
        prune(node);
    }
};

}  // namespace

extern "C" {

void* rt_new(uint64_t seed_hash) { return new Tree(seed_hash); }

void rt_free(void* t) { delete static_cast<Tree*>(t); }

void rt_clear(void* t) { static_cast<Tree*>(t)->clear(); }

void rt_apply_stored(void* tp, uint64_t wid, uint32_t dp, int has_parent,
                     uint64_t parent_seq, const uint64_t* seqs,
                     const uint64_t* locals, size_t n) {
    Tree* t = static_cast<Tree*>(tp);
    WKey w{wid, dp};
    uint64_t pseq = has_parent ? parent_seq : t->seed_hash;
    auto it = t->by_seq.find(pseq);
    if (it == t->by_seq.end()) return;  // orphan chain: drop (indexer.py)
    Node* node = it->second;
    for (size_t i = 0; i < n; i++) {
        auto cit = node->children.find(locals[i]);
        Node* child;
        if (cit == node->children.end()) {
            child = new Node{locals[i], seqs[i], node, {}, {}};
            node->children.emplace(locals[i], child);
            // OVERWRITE like Python's `_by_seq[b.seq_hash] = child`: a
            // divergent worker stream can reuse a seq hash under another
            // parent, and equivalence must hold even then
            t->by_seq[seqs[i]] = child;
        } else {
            child = cit->second;
        }
        child->add_worker(w);
        t->worker_blocks[w].insert(seqs[i]);
        node = child;
    }
}

void rt_apply_removed(void* tp, uint64_t wid, uint32_t dp,
                      const uint64_t* seqs, size_t n) {
    Tree* t = static_cast<Tree*>(tp);
    WKey w{wid, dp};
    for (size_t i = 0; i < n; i++) t->remove_one(w, seqs[i]);
}

void rt_apply_cleared(void* tp, uint64_t wid, uint32_t dp) {
    Tree* t = static_cast<Tree*>(tp);
    WKey w{wid, dp};
    auto it = t->worker_blocks.find(w);
    if (it != t->worker_blocks.end()) {
        std::vector<uint64_t> seqs(it->second.begin(), it->second.end());
        for (uint64_t sh : seqs) t->remove_one(w, sh);
    }
    t->worker_blocks.erase(w);
}

// Walk the query prefix; out arrays are parallel (worker_id, dp, score).
// Returns the number of scored workers; *matched_blocks = walk depth.
size_t rt_find_matches(void* tp, const uint64_t* locals, size_t n,
                       uint64_t* out_wid, uint32_t* out_dp,
                       uint32_t* out_score, size_t cap,
                       uint32_t* matched_blocks) {
    Tree* t = static_cast<Tree*>(tp);
    std::unordered_map<WKey, uint32_t, WKeyHash> scores;
    Node* node = t->root;
    uint32_t depth = 0;
    for (size_t i = 0; i < n; i++) {
        auto cit = node->children.find(locals[i]);
        if (cit == node->children.end()) break;
        depth++;
        for (const WKey& w : cit->second->workers) {
            auto sit = scores.find(w);
            uint32_t cur = (sit == scores.end()) ? 0 : sit->second;
            if (cur == depth - 1) scores[w] = depth;  // consecutive only
        }
        node = cit->second;
    }
    *matched_blocks = depth;
    size_t k = 0;
    for (const auto& kv : scores) {
        if (k >= cap) break;
        out_wid[k] = kv.first.wid;
        out_dp[k] = kv.first.dp;
        out_score[k] = kv.second;
        k++;
    }
    return k;
}

size_t rt_num_workers(void* tp) {
    return static_cast<Tree*>(tp)->worker_blocks.size();
}

size_t rt_workers(void* tp, uint64_t* out_wid, uint32_t* out_dp,
                  size_t cap) {
    Tree* t = static_cast<Tree*>(tp);
    size_t k = 0;
    for (const auto& kv : t->worker_blocks) {
        if (k >= cap) break;
        out_wid[k] = kv.first.wid;
        out_dp[k] = kv.first.dp;
        k++;
    }
    return k;
}

uint64_t rt_block_count(void* tp, uint64_t wid, uint32_t dp) {
    Tree* t = static_cast<Tree*>(tp);
    auto it = t->worker_blocks.find(WKey{wid, dp});
    return it == t->worker_blocks.end() ? 0 : it->second.size();
}

// Snapshot rows: one per (edge, worker). Call with cap=0 to size.
size_t rt_dump(void* tp, uint64_t* wid, uint32_t* dp, uint64_t* parent_seq,
               uint64_t* seq, uint64_t* local, size_t cap) {
    Tree* t = static_cast<Tree*>(tp);
    size_t k = 0;
    std::vector<Node*> stack{t->root};
    while (!stack.empty()) {
        Node* node = stack.back();
        stack.pop_back();
        for (const auto& kv : node->children) {
            Node* child = kv.second;
            for (const WKey& w : child->workers) {
                if (cap && k < cap) {
                    wid[k] = w.wid;
                    dp[k] = w.dp;
                    parent_seq[k] = node->seq_hash;
                    seq[k] = child->seq_hash;
                    local[k] = child->local_hash;
                }
                k++;
            }
            stack.push_back(child);
        }
    }
    return k;
}

}  // extern "C"
