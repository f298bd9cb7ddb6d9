/* CTC prefix beam search with optional n-gram LM shallow fusion: the
 * port's C++ host decoder (decode.mode="beam_fused" with
 * decode.host_impl "native" or "auto"), a copy of the JAX package's
 * native/src/beam.cc. The DS2 lineage ships this search as C++ for
 * speed; the on-device search is deepspeech_tpu_torch/decode/beam.py.
 *
 * Semantics contract: identical hypotheses and scores to the Python
 * oracle deepspeech_tpu_torch/decode/beam_host.py
 * (prefix_beam_search_host; Hannun et al. prefix search; fusion =
 * alpha*log10 P_lm + beta per closed word, char mode when
 * space_id < 0). Held in tests/test_torch_native_decoder.py.
 *
 * Prefixes live in a trie so each beam entry is one int; per-step
 * extension merging is hash-map keyed by (trie node, symbol), exactly
 * mirroring the oracle's dict-of-tuples.
 */
#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstring>
#include <limits>
#include <string>
#include <unordered_map>
#include <vector>

#include "c_api.h"
#include "internal.h"

namespace ds2n {
namespace {

constexpr float kLogZero = -std::numeric_limits<float>::infinity();

inline double Lse(double a, double b) {
  if (a == -std::numeric_limits<double>::infinity()) return b;
  if (b == -std::numeric_limits<double>::infinity()) return a;
  double m = a > b ? a : b;
  return m + std::log(std::exp(a - m) + std::exp(b - m));
}

struct TrieNode {
  int32_t parent;  /* -1 for root */
  int32_t sym;     /* symbol appended at this node */
  int32_t depth;   /* prefix length */
};

struct BeamEntry {
  double p_b;      /* log prob of prefix ending in blank */
  double p_nb;     /* log prob of prefix ending in non-blank */
  double bonus;    /* accumulated LM bonus */
  bool bonus_set;
};

class Search {
 public:
  Search(const float* log_probs, int T, int V, int beam_width, int blank_id,
         float prune, const NGramLM* lm, float alpha, float beta,
         int space_id, const char* const* id_to_str)
      : lp_(log_probs), T_(T), V_(V), W_(beam_width), blank_(blank_id),
        prune_(prune), lm_(lm), alpha_(alpha), beta_(beta),
        space_(space_id) {
    nodes_.push_back({-1, -1, 0});
    if (lm_ != nullptr && id_to_str != nullptr) {
      tok_str_.reserve(V);
      tok_lm_id_.reserve(V);
      for (int v = 0; v < V; ++v) {
        tok_str_.emplace_back(id_to_str[v] ? id_to_str[v] : "");
        /* Char-mode fusion scores each token as an LM "word". */
        tok_lm_id_.push_back(lm_->WordId(tok_str_.back()));
      }
    }
  }

  /* Returns hypotheses best-first as (ids, score). */
  std::vector<std::pair<std::vector<int32_t>, double>> Run();

 private:
  /* Prefix ids root->leaf for a trie node. */
  std::vector<int32_t> Ids(int32_t node) const {
    std::vector<int32_t> out(nodes_[node].depth);
    for (int32_t n = node; n > 0; n = nodes_[n].parent)
      out[nodes_[n].depth - 1] = nodes_[n].sym;
    return out;
  }

  int32_t Child(int32_t parent, int32_t sym) {
    uint64_t key = (static_cast<uint64_t>(parent) << 32) |
                   static_cast<uint32_t>(sym);
    auto it = children_.find(key);
    if (it != children_.end()) return it->second;
    int32_t id = static_cast<int32_t>(nodes_.size());
    nodes_.push_back({parent, sym, nodes_[parent].depth + 1});
    children_.emplace(key, id);
    return id;
  }

  /* LM bonus increment when node `ext` was just created by appending
   * symbol `sym` (mirrors _LMState.char_bonus / word_bonus). */
  double BonusIncrement(int32_t ext, int32_t sym);

  /* Words (as LM ids) of the prefix at `node`, split on space_;
   * `last_word` receives the trailing (possibly empty) word. */
  void WordsOf(int32_t node, std::vector<int32_t>* closed,
               std::vector<int32_t>* last_word_syms) const;

  int32_t LmWordIdOfSyms(const std::vector<int32_t>& syms) const {
    std::string w;
    for (int32_t s : syms) w += tok_str_[s];
    return lm_->WordId(w);
  }

  const float* lp_;
  int T_, V_, W_, blank_;
  float prune_;
  const NGramLM* lm_;
  float alpha_, beta_;
  int space_;
  std::vector<std::string> tok_str_;
  std::vector<int32_t> tok_lm_id_;
  std::vector<TrieNode> nodes_;
  std::unordered_map<uint64_t, int32_t> children_;
};

void Search::WordsOf(int32_t node, std::vector<int32_t>* closed,
                     std::vector<int32_t>* last_word_syms) const {
  /* Collect prefix symbols, then split into words on space_. */
  std::vector<int32_t> ids = Ids(node);
  closed->clear();
  last_word_syms->clear();
  std::vector<int32_t> cur;
  for (int32_t s : ids) {
    if (s == space_) {
      closed->push_back(cur.empty() ? -1 : LmWordIdOfSyms(cur));
      cur.clear();
    } else {
      cur.push_back(s);
    }
  }
  *last_word_syms = cur;
}

double Search::BonusIncrement(int32_t ext, int32_t sym) {
  if (lm_ == nullptr) return 0.0;
  if (space_ < 0) {
    /* Char mode: every extension closes a one-token "word"; history is
     * every earlier token (empty strings filtered like the oracle's
     * `if w` — token surface forms are never empty in practice). */
    std::vector<int32_t> ids = Ids(ext);
    std::vector<int32_t> hist;
    hist.reserve(ids.size() - 1);
    for (size_t i = 0; i + 1 < ids.size(); ++i) {
      if (!tok_str_[ids[i]].empty()) hist.push_back(tok_lm_id_[ids[i]]);
    }
    return alpha_ * lm_->ScoreWordIds(hist, tok_lm_id_[sym], false) + beta_;
  }
  if (sym != space_) return 0.0;
  /* Word mode: a space just closed the previous word. */
  std::vector<int32_t> closed, last;
  WordsOf(ext, &closed, &last);
  /* ext ends in space => last is empty; the closed word is closed.back().
   * Oracle: no bonus when it is empty (double space / leading space). */
  if (closed.size() < 1 || closed.back() == -1) return 0.0;
  std::vector<int32_t> hist;
  for (size_t i = 0; i + 1 < closed.size(); ++i)
    if (closed[i] != -1) hist.push_back(closed[i]);
  return alpha_ * lm_->ScoreWordIds(hist, closed.back(), false) + beta_;
}

std::vector<std::pair<std::vector<int32_t>, double>> Search::Run() {
  std::unordered_map<int32_t, BeamEntry> beams;
  beams.emplace(0, BeamEntry{0.0, -std::numeric_limits<double>::infinity(),
                             0.0, true});
  std::vector<std::pair<int32_t, BeamEntry>> order;  /* sorted scratch */

  for (int t = 0; t < T_; ++t) {
    const float* lp = lp_ + static_cast<size_t>(t) * V_;
    std::unordered_map<int32_t, BeamEntry> next;
    next.reserve(beams.size() * 4);
    auto slot = [&next](int32_t node) -> BeamEntry& {
      auto it = next.find(node);
      if (it == next.end()) {
        it = next.emplace(node,
                          BeamEntry{-std::numeric_limits<double>::infinity(),
                                    -std::numeric_limits<double>::infinity(),
                                    0.0, false}).first;
      }
      return it->second;
    };

    for (const auto& kv : beams) {
      int32_t node = kv.first;
      const BeamEntry& be = kv.second;
      int32_t last = nodes_[node].depth > 0 ? nodes_[node].sym : -1;

      /* Stay on the same prefix: blank, or repeat of last symbol. */
      BeamEntry& stay = slot(node);
      stay.p_b = Lse(stay.p_b, Lse(be.p_b, be.p_nb) + lp[blank_]);
      if (last >= 0) stay.p_nb = Lse(stay.p_nb, be.p_nb + lp[last]);
      if (!stay.bonus_set) { stay.bonus = be.bonus; stay.bonus_set = true; }

      for (int v = 0; v < V_; ++v) {
        if (v == blank_ || lp[v] < prune_) continue;
        int32_t ext = Child(node, v);
        BeamEntry& e = slot(ext);
        if (v == last) {
          e.p_nb = Lse(e.p_nb, be.p_b + lp[v]);  /* through a blank gap */
        } else {
          e.p_nb = Lse(e.p_nb, Lse(be.p_b, be.p_nb) + lp[v]);
        }
        if (!e.bonus_set) {
          e.bonus = be.bonus + BonusIncrement(ext, v);
          e.bonus_set = true;
        }
      }
    }

    order.assign(next.begin(), next.end());
    auto score = [](const std::pair<int32_t, BeamEntry>& kv) {
      return Lse(kv.second.p_b, kv.second.p_nb) + kv.second.bonus;
    };
    int keep = std::min<int>(W_, static_cast<int>(order.size()));
    std::partial_sort(order.begin(), order.begin() + keep, order.end(),
                      [&score](const auto& a, const auto& b) {
                        return score(a) > score(b);
                      });
    beams.clear();
    for (int i = 0; i < keep; ++i) beams.emplace(order[i]);
  }

  std::vector<std::pair<std::vector<int32_t>, double>> out;
  out.reserve(beams.size());
  std::vector<int32_t> closed, lastw;
  for (const auto& kv : beams) {
    double score = Lse(kv.second.p_b, kv.second.p_nb) + kv.second.bonus;
    if (lm_ != nullptr && space_ >= 0) {
      /* Score the final unclosed word with </s>, as the oracle does. */
      WordsOf(kv.first, &closed, &lastw);
      if (!lastw.empty()) {
        std::vector<int32_t> hist;
        for (int32_t w : closed)
          if (w != -1) hist.push_back(w);
        score += alpha_ * lm_->ScoreWordIds(hist, LmWordIdOfSyms(lastw),
                                            /*eos=*/true) +
                 beta_;
      }
    }
    out.emplace_back(Ids(kv.first), score);
  }
  std::sort(out.begin(), out.end(),
            [](const auto& a, const auto& b) { return a.second > b.second; });
  return out;
}

}  // namespace

int BeamSearchOne(const float* log_probs, int T, int V, int beam_width,
                  int blank_id, float prune_log_prob, const NGramLM* lm,
                  float alpha, float beta, int space_id,
                  const char* const* id_to_str, int32_t* out_ids,
                  int32_t* out_lens, float* out_scores, int nbest,
                  int max_len) {
  Search search(log_probs, T, V, beam_width, blank_id, prune_log_prob, lm,
                alpha, beta, space_id, id_to_str);
  auto hyps = search.Run();
  int n = std::min<int>(nbest, static_cast<int>(hyps.size()));
  for (int i = 0; i < n; ++i) {
    const auto& ids = hyps[i].first;
    int len = std::min<int>(max_len, static_cast<int>(ids.size()));
    std::memcpy(out_ids + static_cast<size_t>(i) * max_len, ids.data(),
                sizeof(int32_t) * static_cast<size_t>(len));
    out_lens[i] = len;
    out_scores[i] = static_cast<float>(hyps[i].second);
  }
  return n;
}

}  // namespace ds2n

extern "C" {

int ds2n_beam_search(const float* log_probs, int T, int V, int beam_width,
                     int blank_id, float prune_log_prob, const void* lm,
                     float alpha, float beta, int space_id,
                     const char* const* id_to_str, int32_t* out_ids,
                     int32_t* out_lens, float* out_scores, int nbest,
                     int max_len) {
  if (T < 0 || V <= 0 || beam_width <= 0 || nbest <= 0 || max_len <= 0 ||
      blank_id < 0 || blank_id >= V) {
    ds2n::set_last_error("ds2n_beam_search: invalid arguments");
    return -1;
  }
  if (lm != nullptr && id_to_str == nullptr) {
    ds2n::set_last_error("ds2n_beam_search: LM fusion needs id_to_str");
    return -1;
  }
  return ds2n::BeamSearchOne(
      log_probs, T, V, beam_width, blank_id, prune_log_prob,
      static_cast<const ds2n::NGramLM*>(lm), alpha, beta, space_id,
      id_to_str, out_ids, out_lens, out_scores, nbest, max_len);
}

int ds2n_beam_search_batch(const float* log_probs, int B, int T_max, int V,
                           const int32_t* T_per_utt, int beam_width,
                           int blank_id, float prune_log_prob,
                           const void* lm, float alpha, float beta,
                           int space_id, const char* const* id_to_str,
                           int32_t* out_ids, int32_t* out_lens,
                           float* out_scores, int32_t* out_counts,
                           int nbest, int max_len, int n_threads) {
  if (B < 0 || T_max < 0 || V <= 0 || beam_width <= 0 || nbest <= 0 ||
      max_len <= 0 || blank_id < 0 || blank_id >= V) {
    ds2n::set_last_error("ds2n_beam_search_batch: invalid arguments");
    return -1;
  }
  if (lm != nullptr && id_to_str == nullptr) {
    ds2n::set_last_error("ds2n_beam_search_batch: LM fusion needs id_to_str");
    return -1;
  }
  std::atomic<bool> failed{false};
  ds2n::ParallelFor(B, n_threads, [&](int b) {
    int T = T_per_utt ? T_per_utt[b] : T_max;
    if (T < 0 || T > T_max) { failed.store(true); return; }
    int n = ds2n::BeamSearchOne(
        log_probs + static_cast<size_t>(b) * T_max * V, T, V, beam_width,
        blank_id, prune_log_prob, static_cast<const ds2n::NGramLM*>(lm),
        alpha, beta, space_id, id_to_str,
        out_ids + static_cast<size_t>(b) * nbest * max_len,
        out_lens + static_cast<size_t>(b) * nbest,
        out_scores + static_cast<size_t>(b) * nbest, nbest, max_len);
    out_counts[b] = n;
    if (n < 0) failed.store(true);
  });
  if (failed.load()) {
    ds2n::set_last_error("ds2n_beam_search_batch: an utterance failed");
    return -1;
  }
  return 0;
}

}  /* extern "C" */
