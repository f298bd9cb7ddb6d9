/* ARPA n-gram LM with Katz backoff: the port's C++ query engine behind
 * beam-search LM fusion and n-best rescoring, a copy of the JAX
 * package's native/src/ngram.cc. The DS2 lineage queried the external
 * KenLM C++ library; this engine has KenLM-compatible scoring semantics.
 *
 * The contract is equality with the Python oracle
 * deepspeech_tpu_torch/decode/ngram.py (NGramLM), held in
 * tests/test_torch_native_decoder.py.
 */
#include "internal.h"

#include <atomic>
#include <cmath>
#include <cstdlib>
#include <cstring>
#include <fstream>
#include <memory>
#include <sstream>
#include <thread>

#include "c_api.h"

namespace ds2n {

namespace {
constexpr const char* kBos = "<s>";
constexpr const char* kEos = "</s>";
constexpr const char* kUnk = "<unk>";
/* ngram.py floors OOV queries at -10 log10 when the LM has no <unk>. */
constexpr double kOovFloor = -10.0;

thread_local std::string g_last_error;

std::vector<std::string> SplitWs(const std::string& s) {
  std::vector<std::string> out;
  std::istringstream iss(s);
  std::string w;
  while (iss >> w) out.push_back(w);
  return out;
}
}  // namespace

void set_last_error(const std::string& msg) { g_last_error = msg; }
const std::string& last_error_ref() { return g_last_error; }

std::string NGramLM::Key(const int32_t* ids, int n) {
  return std::string(reinterpret_cast<const char*>(ids),
                     sizeof(int32_t) * static_cast<size_t>(n));
}

NGramLM* NGramLM::LoadArpa(const char* path) {
  std::ifstream f(path);
  if (!f) {
    set_last_error(std::string("cannot open ARPA file: ") + path);
    return nullptr;
  }
  auto lm = std::unique_ptr<NGramLM>(new NGramLM());
  auto intern = [&lm](const std::string& w) -> int32_t {
    auto it = lm->vocab_.find(w);
    if (it != lm->vocab_.end()) return it->second;
    int32_t id = static_cast<int32_t>(lm->vocab_.size());
    lm->vocab_.emplace(w, id);
    return id;
  };

  std::string line;
  int section = 0;
  bool in_data = false;
  std::vector<int32_t> ids;
  while (std::getline(f, line)) {
    /* strip() as the oracle does (also handles \r\n ARPA files). */
    size_t b = line.find_first_not_of(" \t\r\n");
    if (b == std::string::npos) continue;
    size_t e = line.find_last_not_of(" \t\r\n");
    std::string s = line.substr(b, e - b + 1);
    if (s == "\\data\\") { in_data = true; continue; }
    if (in_data && s.rfind("ngram ", 0) == 0) continue;
    if (s.size() > 1 && s[0] == '\\' &&
        s.size() >= 8 && s.compare(s.size() - 7, 7, "-grams:") == 0) {
      section = std::atoi(s.c_str() + 1);
      if (section > lm->order_) lm->order_ = section;
      continue;
    }
    if (s == "\\end\\") break;
    if (!section) continue;

    /* "logp<TAB>w1 .. wn<TAB>backoff" or fully whitespace-split. */
    std::vector<std::string> parts = SplitWs(s);
    if (static_cast<int>(parts.size()) < 1 + section) continue;
    float logp = std::strtof(parts[0].c_str(), nullptr);
    float backoff = 0.0f;
    if (static_cast<int>(parts.size()) > 1 + section)
      backoff = std::strtof(parts[1 + section].c_str(), nullptr);
    ids.clear();
    for (int i = 0; i < section; ++i) ids.push_back(intern(parts[1 + i]));
    lm->grams_[Key(ids.data(), section)] = {logp, backoff};
  }
  if (!lm->order_) {
    set_last_error(std::string("no n-gram sections found in ") + path);
    return nullptr;
  }
  auto it_unk = lm->vocab_.find(kUnk);
  lm->unk_id_ = it_unk == lm->vocab_.end() ? kUnmatched : it_unk->second;
  /* "has unk" means the *unigram* (<unk>,) exists, as in the oracle. */
  lm->has_unk_ = lm->unk_id_ != kUnmatched &&
                 lm->Lookup(&lm->unk_id_, 1) != nullptr;
  /* <s>/</s> go through the same unk mapping as any other token (the
   * oracle maps every history word via _map_unk). */
  lm->bos_id_ = lm->WordId(kBos);
  lm->eos_id_ = lm->WordId(kEos);
  return lm.release();
}

const std::pair<float, float>* NGramLM::Lookup(const int32_t* ids,
                                               int n) const {
  auto it = grams_.find(Key(ids, n));
  return it == grams_.end() ? nullptr : &it->second;
}

int32_t NGramLM::WordId(const std::string& word) const {
  auto it = vocab_.find(word);
  if (it != vocab_.end()) {
    /* In-vocab string; but _map_unk also requires the unigram to exist
     * (a word seen only inside higher-order grams is still OOV). */
    int32_t id = it->second;
    if (Lookup(&id, 1) != nullptr) return id;
  }
  return has_unk_ ? unk_id_ : kUnmatched;
}

double NGramLM::BackoffLogp(const int32_t* hist, int n, int32_t word) const {
  std::vector<int32_t> full(hist, hist + n);
  full.push_back(word);
  if (const auto* entry = Lookup(full.data(), n + 1)) return entry->first;
  if (n == 0) {
    /* Unigram must exist (guaranteed by the <unk>/floor check above). */
    const auto* uni = Lookup(&word, 1);
    return uni ? uni->first : kOovFloor;
  }
  const auto* bo = Lookup(hist, n);
  double backoff = bo ? bo->second : 0.0;
  return backoff + BackoffLogp(hist + 1, n - 1, word);
}

double NGramLM::Logp(std::vector<int32_t> history, int32_t word) const {
  if (word == kUnmatched) return kOovFloor;  /* OOV, no <unk> */
  int ctx = order_ > 1 ? order_ - 1 : 0;
  int start = static_cast<int>(history.size()) > ctx
                  ? static_cast<int>(history.size()) - ctx
                  : 0;
  return BackoffLogp(history.data() + start,
                     static_cast<int>(history.size()) - start, word);
}

double NGramLM::ScoreWordIds(const std::vector<int32_t>& history_ids,
                             int32_t word_id, bool eos) const {
  std::vector<int32_t> hist;
  hist.reserve(history_ids.size() + 2);
  hist.push_back(bos_id_);
  for (int32_t h : history_ids) hist.push_back(h);
  double logp = Logp(hist, word_id);
  if (eos) {
    hist.push_back(word_id == kUnmatched ? kUnmatched : word_id);
    logp += Logp(hist, eos_id_);
  }
  return logp;
}

double NGramLM::ScoreWord(const std::vector<std::string>& history_words,
                          const std::string& word, bool eos) const {
  std::vector<int32_t> hist;
  hist.reserve(history_words.size());
  for (const auto& w : history_words)
    if (!w.empty()) hist.push_back(WordId(w));
  return ScoreWordIds(hist, WordId(word), eos);
}

double NGramLM::ScoreSentence(const std::string& sentence,
                              bool include_eos) const {
  std::vector<std::string> words = SplitWs(sentence);
  std::vector<int32_t> hist{bos_id_};
  double total = 0.0;
  for (const auto& w : words) {
    int32_t id = WordId(w);
    total += Logp(hist, id);
    hist.push_back(id);
  }
  if (include_eos) total += Logp(hist, eos_id_);
  return total;
}

void ParallelFor(int n, int n_threads, const std::function<void(int)>& fn) {
  if (n <= 0) return;
  if (n_threads <= 0) {
    unsigned hw = std::thread::hardware_concurrency();
    n_threads = hw ? static_cast<int>(hw) : 4;
  }
  if (n_threads > n) n_threads = n;
  if (n_threads <= 1) {
    for (int i = 0; i < n; ++i) fn(i);
    return;
  }
  std::vector<std::thread> workers;
  workers.reserve(n_threads);
  std::atomic<int> next{0};
  for (int w = 0; w < n_threads; ++w) {
    workers.emplace_back([&]() {
      for (int i = next.fetch_add(1); i < n; i = next.fetch_add(1)) fn(i);
    });
  }
  for (auto& t : workers) t.join();
}

}  // namespace ds2n

/* ------------------------------------------------------------- C ABI -- */

extern "C" {

void* ds2n_lm_load(const char* arpa_path) {
  return ds2n::NGramLM::LoadArpa(arpa_path);
}

void ds2n_lm_free(void* lm) { delete static_cast<ds2n::NGramLM*>(lm); }

int ds2n_lm_order(const void* lm) {
  return lm ? static_cast<const ds2n::NGramLM*>(lm)->order() : 0;
}

double ds2n_lm_score_word(const void* lm, const char* const* history,
                          int n_hist, const char* word, int eos) {
  const auto* m = static_cast<const ds2n::NGramLM*>(lm);
  std::vector<std::string> hist;
  hist.reserve(n_hist);
  for (int i = 0; i < n_hist; ++i) hist.emplace_back(history[i]);
  return m->ScoreWord(hist, word, eos != 0);
}

double ds2n_lm_score_sentence(const void* lm, const char* sentence,
                              int include_eos) {
  return static_cast<const ds2n::NGramLM*>(lm)->ScoreSentence(
      sentence, include_eos != 0);
}

const char* ds2n_last_error(void) {
  return ds2n::last_error_ref().c_str();
}

int ds2n_abi_version(void) { return 1; }

void ds2n_free(void* p) { free(p); }

}  /* extern "C" */
