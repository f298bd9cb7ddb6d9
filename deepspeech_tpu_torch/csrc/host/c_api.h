/* C API of the port's C++ host library: the n-gram query engine, the
 * CTC prefix beam-search decoder and the audio/DSP loader of the JAX
 * package's native/src/c_api.h.
 *
 * Bound from Python with ctypes (deepspeech_tpu_torch/native.py). All
 * functions are thread-safe for distinct handles; a handle must not be
 * used concurrently from multiple threads unless noted.
 */
#ifndef DS2NATIVE_C_API_H_
#define DS2NATIVE_C_API_H_

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

/* ---------------------------------------------------------------- LM -- */

/* Load an ARPA word/char n-gram LM.  Returns NULL on failure (message
 * retrievable via ds2n_last_error). */
void* ds2n_lm_load(const char* arpa_path);
void ds2n_lm_free(void* lm);
int ds2n_lm_order(const void* lm);

/* log10 P(word | <s> + history) with Katz backoff; KenLM-compatible unk
 * handling.  history: n_hist utf-8 words.  eos!=0 additionally scores
 * the </s> transition after `word` (end-of-utterance).  Thread-safe
 * (read-only on the handle). */
double ds2n_lm_score_word(const void* lm, const char* const* history,
                          int n_hist, const char* word, int eos);

/* Total log10 prob of a whitespace-split sentence (KenLM score()
 * semantics, bos always, eos when include_eos!=0). */
double ds2n_lm_score_sentence(const void* lm, const char* sentence,
                              int include_eos);

/* ------------------------------------------------------- beam search -- */

/* CTC prefix beam search over one utterance, optionally with n-gram LM
 * shallow fusion (score = logP_ctc + alpha*log10 P_lm + beta*|words|).
 *
 *   log_probs      [T, V] row-major log-softmax
 *   beam_width     prefixes kept per step
 *   blank_id       CTC blank index
 *   prune_log_prob symbols with log prob < threshold are not extended
 *   lm             NULL disables fusion
 *   space_id       >=0: word-level fusion, symbol closing a word;
 *                  -1: char-level fusion (Mandarin)
 *   id_to_str      V utf-8 strings (token surface forms); may be NULL
 *                  when lm is NULL
 *   out_ids        [nbest * max_len] int32, hypothesis i at i*max_len
 *   out_lens       [nbest]
 *   out_scores     [nbest] combined scores, best first
 *
 * Returns the number of hypotheses written (<= nbest), or -1 on error.
 * Thread-safe (lm handle is read-only). */
int ds2n_beam_search(const float* log_probs, int T, int V, int beam_width,
                     int blank_id, float prune_log_prob, const void* lm,
                     float alpha, float beta, int space_id,
                     const char* const* id_to_str, int32_t* out_ids,
                     int32_t* out_lens, float* out_scores, int nbest,
                     int max_len);

/* Batched variant over B utterances with an internal thread pool.
 * log_probs is [B, T_max, V]; T_per_utt gives each utterance's valid
 * frame count.  Outputs are the single-utterance layouts repeated B
 * times (out_ids: [B * nbest * max_len], ...).  out_counts[b] receives
 * the per-utterance hypothesis count.  n_threads<=0 = hardware count.
 * Returns 0, or -1 on error. */
int ds2n_beam_search_batch(const float* log_probs, int B, int T_max, int V,
                           const int32_t* T_per_utt, int beam_width,
                           int blank_id, float prune_log_prob,
                           const void* lm, float alpha, float beta,
                           int space_id, const char* const* id_to_str,
                           int32_t* out_ids, int32_t* out_lens,
                           float* out_scores, int32_t* out_counts,
                           int nbest, int max_len, int n_threads);

/* ------------------------------------------------------ audio / DSP -- */

/* Number of frames the featurizer produces for n samples (0 if n<win). */
int ds2n_num_frames(int n_samples, int win, int hop);

/* Log-magnitude spectrogram with optional pre-emphasis and
 * per-utterance normalization; matches
 * deepspeech_tpu_torch.data.features.featurize_np in layout:
 * out is [T, F] with F = n_fft/2 + 1, T = ds2n_num_frames(...).
 * Returns T, or -1 on error. */
int ds2n_featurize(const float* audio, int n_samples, int win, int hop,
                   int n_fft, float preemph, int normalize, float eps,
                   float* out);

/* Parse a PCM WAV file (8/16/32-bit int or float32, any channel count;
 * channels are averaged to mono).  On success *out receives a malloc'd
 * float32 buffer (release with ds2n_free) and *n_samples its length;
 * returns the sample rate, or -1 on error. */
int ds2n_load_wav(const char* path, float** out, int* n_samples);

/* End-to-end native loader: read B wav files, featurize each with a
 * thread pool, write padded features into out [B, max_frames, F] and
 * per-utterance frame counts into out_frames (clipped to max_frames).
 * Files whose sample rate != sample_rate, or that fail to parse, get
 * out_frames[b] = -1 and a zero row.  Returns 0, or -1 on hard error. */
int ds2n_load_featurize_batch(const char* const* paths, int B,
                              int sample_rate, int win, int hop, int n_fft,
                              float preemph, int normalize, float eps,
                              int max_frames, float* out,
                              int32_t* out_frames, int n_threads);

/* Featurize B in-memory audio buffers with a thread pool into the same
 * padded layout as ds2n_load_featurize_batch. */
int ds2n_featurize_batch(const float* const* audios, const int32_t* lens,
                         int B, int win, int hop, int n_fft, float preemph,
                         int normalize, float eps, int max_frames,
                         float* out, int32_t* out_frames, int n_threads);

/* ------------------------------------------------------------- misc -- */

void ds2n_free(void* p);

/* Last error message for the calling thread ("" when none). */
const char* ds2n_last_error(void);

/* Library ABI version (bump on incompatible change). */
int ds2n_abi_version(void);

#ifdef __cplusplus
}  /* extern "C" */
#endif

#endif  /* DS2NATIVE_C_API_H_ */
