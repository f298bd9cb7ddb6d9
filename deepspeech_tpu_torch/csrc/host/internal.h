/* Internal shared declarations of the host decoder (not part of the C ABI). */
#ifndef DS2NATIVE_INTERNAL_H_
#define DS2NATIVE_INTERNAL_H_

#include <cstdint>
#include <functional>
#include <string>
#include <unordered_map>
#include <utility>
#include <vector>

namespace ds2n {

void set_last_error(const std::string& msg);
const std::string& last_error_ref();

/* Word n-gram LM with Katz backoff, loaded from ARPA.  Mirrors the
 * semantics of deepspeech_tpu_torch/decode/ngram.py (NGramLM) exactly (that
 * module is the tested Python oracle): log10 scores, <s>/</s>/<unk>
 * handling, OOV history words kept as never-matching sentinels. */
class NGramLM {
 public:
  static NGramLM* LoadArpa(const char* path);  /* nullptr on failure */

  int order() const { return order_; }

  /* log10 P(word | <s> + history_words), optionally + log10 P(</s> | ...).
   * Mirrors NGramLM.score_word (ngram.py). */
  double ScoreWord(const std::vector<std::string>& history_words,
                   const std::string& word, bool eos) const;

  double ScoreSentence(const std::string& sentence, bool include_eos) const;

  /* Beam-search fast path: ids resolved once via WordId(). */
  double ScoreWordIds(const std::vector<int32_t>& history_ids,
                      int32_t word_id, bool eos) const;

  /* Vocabulary id for a surface form; kUnmatched when OOV and the LM has
   * no <unk> (such ids never match any stored n-gram, reproducing the
   * oracle's behavior for unknown strings). */
  int32_t WordId(const std::string& word) const;

  static constexpr int32_t kUnmatched = -2;

 private:
  NGramLM() = default;

  double Logp(std::vector<int32_t> history, int32_t word) const;
  double BackoffLogp(const int32_t* hist, int n, int32_t word) const;
  const std::pair<float, float>* Lookup(const int32_t* ids, int n) const;

  /* Grams keyed by their id sequence packed into a byte string. */
  static std::string Key(const int32_t* ids, int n);

  std::unordered_map<std::string, int32_t> vocab_;
  std::unordered_map<std::string, std::pair<float, float>> grams_;
  int order_ = 0;
  bool has_unk_ = false;
  int32_t bos_id_ = kUnmatched, eos_id_ = kUnmatched, unk_id_ = kUnmatched;
};

/* Shared fixed-size thread pool helper: runs fn(i) for i in [0, n). */
void ParallelFor(int n, int n_threads, const std::function<void(int)>& fn);

}  // namespace ds2n

#endif  /* DS2NATIVE_INTERNAL_H_ */
