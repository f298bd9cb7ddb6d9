#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (deepspeech_tpu_torch) on one NVIDIA card.

Run from the root of a checkout: ``python3 chip_smoke.py``. It

1. prints the card's name and power limit (nvidia-smi);
2. builds every kernel under deepspeech_tpu_torch/csrc with nvcc;
3. kernel phase: holds each kernel against its plain PyTorch version on
   the card at the main path's shapes (B=32, T'=850 -- the 1700-frame
   bucket over time stride 2 -- H=800, ragged lengths) and times the
   kernel, the plain version and one PyTorch library call that does the
   same recurrence (cuDNN's GRU, which also does the input projection)
   with CUDA events;
4. path phases: greedy inference through ``Inferencer.decode_batch_bucketed``
   at the full width of ds2_small (3 BiGRU layers) and of ds2_streaming
   (5 GRU layers + lookahead) from a seeded random init, on a request of
   mixed lengths; counts the kernel launches of that run, and holds the
   RNN stack's output and the greedy argmax against the same forward
   with the plain GRU on the card, beside a mis-directed GRU that the
   check must reject;
5. prints a ``{"kernels": [...]}`` line, the card line, and as the last
   line ``{"ok": true, "device": {...}}``.

Any failed check raises and the script exits non-zero; without CUDA it
exits non-zero before printing any result.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch

SEED = 0
B, T, H = 32, 850, 800          # main-path shapes of the recurrence
PEAK_BF16_FLOPS = 989e12        # H100 SXM dense bf16, NVIDIA data sheet
PEAK_F32_FLOPS = 67e12          # H100 SXM f32 outside the tensor cores
PEAK_BYTES = 3.35e12            # H100 SXM HBM3
TOL = {torch.bfloat16: 3e-2, torch.float32: 1e-4}
# End to end, bf16: ||rnn - rnn_plain|| / ||rnn_plain|| over valid frames
# of the RNN stack's output. On an H100 the kernel reads 1.6e-3
# (ds2_small) and 2.8e-3 (ds2_streaming); a zeroed GRU reads 1, and a
# mis-directed one (the control in path_phase, read on every run) 0.25
# and 0.38.
RNN_REL_TOL = 2e-2
ARGMAX_FLOOR = 0.98             # share of valid frames, kernel vs plain


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def _time_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _gru_inputs(d: int, dtype: torch.dtype, with_h0: bool, gen,
                t: int = T, b: int = B, h: int = H):
    dev = "cuda"
    lens = torch.randint(t // 3, t + 1, (b,), generator=gen, device=dev)
    lens[0] = t
    mask = (torch.arange(t, device=dev)[:, None] < lens[None, :]).float()
    xp = torch.randn(t, b, 3 * h, generator=gen, device=dev).to(dtype)
    w = (torch.randn(d, h, 3 * h, generator=gen, device=dev)
         / math.sqrt(h)).to(dtype)
    bias = torch.randn(d, 3 * h, generator=gen, device=dev) * 0.1
    h0 = (torch.randn(d, b, h, generator=gen, device=dev) * 0.5
          if with_h0 else None)
    reverse = (False, True)[:d]
    return (xp, mask.contiguous(), w, bias, h0, reverse), int(lens.sum())


def _bound(args, valid_rows: int):
    """Least time for gru_fwd on these inputs: the larger of its product
    FLOPs on valid frames over the peak for the dot dtype, and each
    input read once plus each output written once over HBM bandwidth."""
    xp, mask, w, b, h0, _ = args
    d = w.shape[0]
    flops = 2.0 * valid_rows * d * H * 3 * H
    peak = PEAK_BF16_FLOPS if w.dtype == torch.bfloat16 else PEAK_F32_FLOPS
    nbytes = sum(t.numel() * t.element_size()
                 for t in (xp, mask, w, b, h0) if t is not None)
    nbytes += (d * T * B * H + d * B * H) * 4  # ys, hfin
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def kernel_phase(gen):
    from deepspeech_tpu_torch.ops.gru import gru_fwd, gru_fwd_plain

    checks = {}
    # The main path's shapes, then one ragged shape off the kernel's
    # tiles: H not a multiple of 16 or 64, B above one 32-row pass.
    for name, d, dtype, with_h0, shape in (
            ("D2_bf16", 2, torch.bfloat16, False, (T, B, H)),
            ("D2_f32", 2, torch.float32, False, (T, B, H)),
            ("D1_bf16_h0", 1, torch.bfloat16, True, (T, B, H)),
            ("D1_f32_h0", 1, torch.float32, True, (T, B, H)),
            ("D2_bf16_ragged", 2, torch.bfloat16, True, (37, 45, 100))):
        args, valid = _gru_inputs(d, dtype, with_h0, gen, *shape)
        ys, hfin = gru_fwd(*args)
        torch.cuda.synchronize()
        ys_p, hfin_p = gru_fwd_plain(*args)
        err = max(float((ys - ys_p).abs().max()),
                  float((hfin - hfin_p).abs().max()))
        _require(bool(torch.isfinite(ys).all()), f"{name}: non-finite ys")
        _require(err <= TOL[dtype],
                 f"gru_fwd {name}: max |kernel - plain| {err} > {TOL[dtype]}")
        checks[name] = {"max_abs_err": err, "tol": TOL[dtype]}
        print(json.dumps({"check": f"gru_fwd {name}", "max_abs_err": err,
                          "tol": TOL[dtype]}), flush=True)

    entries = []
    for d, replaces, check in ((2, "deepspeech_tpu/ops/rnn_pallas.py:155",
                                "D2_bf16"),
                               (1, "deepspeech_tpu/ops/rnn_pallas.py:85",
                                "D1_bf16_h0")):
        args, valid = _gru_inputs(d, torch.bfloat16, False, gen)
        ms = _time_ms(lambda: gru_fwd(*args), reps=5)
        plain_ms = _time_ms(lambda: gru_fwd_plain(*args), reps=1)
        cudnn = torch.nn.GRU(H, H, bidirectional=d == 2).to(
            "cuda", torch.bfloat16)
        cudnn.flatten_parameters()
        x_lib = torch.randn(T, B, H, generator=gen, device="cuda").to(
            torch.bfloat16)
        with torch.no_grad():
            library_ms = _time_ms(lambda: cudnn(x_lib), reps=5)
        bound_ms, bound_by = _bound(args, valid)
        # The same call at B=1. A block computes a 32-row batch tile
        # whatever B is, so this is the part of the time that does not
        # scale with B up to 32.
        args_b1 = tuple(a[:, :1].contiguous() if i < 2 else a
                        for i, a in enumerate(args))
        ms_b1 = _time_ms(lambda: gru_fwd(*args_b1), reps=5)
        entries.append({
            "name": f"gru_fwd[D={d}]", "route": "cuda",
            "source": "deepspeech_tpu_torch/csrc/gru_fwd.cu",
            "replaces": replaces, "launches": 0,
            "max_abs_err": checks[check]["max_abs_err"],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms,
            "ms_at_b1": ms_b1,
            "shape": {"D": d, "T": T, "B": B, "H": H, "dtype": "bfloat16",
                      "valid_rows": valid},
            "checks": {k: v for k, v in checks.items()
                       if k.startswith(f"D{d}_")}})
        print(json.dumps({"timed": entries[-1]["name"], "ms": ms,
                          "ms_at_b1": ms_b1, "plain_ms": plain_ms,
                          "library_ms": library_ms, "bound_ms": bound_ms}),
              flush=True)
    return entries


def _request(cfg, n: int, rng):
    """A request of ``n`` utterances, 300..1700 frames, one of 1700."""
    lens = rng.integers(300, 1701, size=n).astype(np.int32)
    lens[0] = 1700
    f = cfg.features.num_features
    feats = np.zeros((n, int(lens.max()), f), np.float32)
    for i, t in enumerate(lens):
        feats[i, :t] = rng.normal(size=(t, f))
    return {"features": feats, "feat_lens": lens}


def _forward(inf, sub):
    """Log-probs, lengths and the RNN stack's output (f32) of one
    forward of ``inf`` on the request ``sub``, synchronised."""
    out = {}
    hook = inf.model.rnn.register_forward_hook(
        lambda mod, args, y: out.update(rnn=y))
    try:
        lp, lens = inf.forward(sub["features"], sub["feat_lens"])
    finally:
        hook.remove()
    torch.cuda.synchronize()
    return lp, lens, out["rnn"].float()


def path_phase(preset: str, layers_per_forward: int):
    from deepspeech_tpu_torch.bridge import init_params
    from deepspeech_tpu_torch.config import get_config
    from deepspeech_tpu_torch.data import CharTokenizer, plan_infer_buckets
    from deepspeech_tpu_torch.data.infer_bucket import slice_to_plan
    from deepspeech_tpu_torch.infer import Inferencer
    from deepspeech_tpu_torch.ops.gru import gru_fwd, gru_fwd_plain

    cfg = get_config(preset)
    params, stats = init_params(cfg, torch.Generator().manual_seed(SEED))
    tok = CharTokenizer.english()
    inf = Inferencer(cfg, tok, params, stats)
    rng = np.random.default_rng(SEED)
    batch = _request(cfg, 12, rng)
    plans = plan_infer_buckets(batch["feat_lens"], cfg.data.bucket_frames,
                               cfg.data.batch_size)
    inf.decode_batch_bucketed(batch)  # warm-up: cuBLAS/cuDNN handles
    torch.cuda.synchronize()

    gru_fwd.launches = 0
    t0 = time.perf_counter()
    texts = inf.decode_batch_bucketed(batch)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = gru_fwd.launches
    want = layers_per_forward * len(plans)
    _require(launches == want, f"{preset}: gru_fwd launched {launches} "
             f"times for {len(plans)} forwards, want {want}")
    _require(len(texts) == 12 and all(isinstance(s, str) for s in texts),
             f"{preset}: bad transcripts {texts!r}")

    # The largest rung against the plain GRU on the card, and against a
    # GRU whose first direction runs the wrong way through time, which
    # the check must reject. (Swapping both directions of a BiGRU would
    # not do: the sum of two random directions is nearly symmetric.)
    def misdirected(xp, mask, w, b, h0, reverse):
        return gru_fwd(xp, mask, w, b, h0,
                       [not reverse[0], *reverse[1:]])

    sub = slice_to_plan(batch, plans[-1])
    lp, lens, rnn = _forward(inf, sub)
    with mock.patch("deepspeech_tpu_torch.models.rnn.gru_fwd",
                    gru_fwd_plain):
        t1 = time.perf_counter()
        lp_p, lens_p, rnn_p = _forward(inf, sub)
        plain_s = time.perf_counter() - t1
    with mock.patch("deepspeech_tpu_torch.models.rnn.gru_fwd", misdirected):
        _, _, rnn_bad = _forward(inf, sub)
    t_out = -(-plans[-1].bucket_frames // cfg.model.time_stride)
    _require(tuple(lp.shape) == (plans[-1].batch_pad, t_out,
                                 cfg.model.vocab_size),
             f"{preset}: log-probs shape {tuple(lp.shape)}")
    _require(bool(torch.isfinite(lp).all()), f"{preset}: non-finite")
    _require(torch.equal(lens, lens_p), f"{preset}: lengths differ")
    valid = (torch.arange(t_out, device=lp.device)[None] < lens[:, None])

    def rel(x):
        return float((x - rnn_p)[valid].norm() / rnn_p[valid].norm())

    rnn_err, bad_err = rel(rnn), rel(rnn_bad)
    lp_err = float((lp - lp_p).abs()[valid].max())
    agree = float((lp.argmax(-1) == lp_p.argmax(-1))[valid].float().mean())
    _require(rnn_err <= RNN_REL_TOL,
             f"{preset}: RNN output differs from the plain GRU path by "
             f"{rnn_err} > {RNN_REL_TOL} (relative)")
    _require(bad_err > RNN_REL_TOL,
             f"{preset}: a mis-directed GRU reads {bad_err}, within "
             f"{RNN_REL_TOL}: the check cannot tell it from the kernel")
    _require(agree >= ARGMAX_FLOOR,
             f"{preset}: argmax agrees with the plain GRU path on {agree} "
             f"of valid frames < {ARGMAX_FLOOR}")

    # Throughput at the largest rung, full batch.
    full = _request(cfg, cfg.data.batch_size, rng)
    full["feat_lens"][:] = 1700
    full["features"] = np.broadcast_to(
        full["features"][:1, :1700], (cfg.data.batch_size, 1700,
                                      cfg.features.num_features)).copy()
    inf.decode_batch(full)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    inf.decode_batch(full)
    torch.cuda.synchronize()
    full_s = time.perf_counter() - t2
    result = {"path": preset, "utts": 12, "forwards": len(plans),
              "rungs": [[p.batch_pad, p.bucket_frames] for p in plans],
              "seconds": seconds, "utt_per_s": 12 / seconds,
              "gru_fwd_launches": launches,
              "full_rung": [cfg.data.batch_size, 1700],
              "full_rung_seconds": full_s,
              "full_rung_utt_per_s": cfg.data.batch_size / full_s,
              "plain_gru_forward_seconds": plain_s,
              "rnn_rel_err": rnn_err, "rnn_rel_tol": RNN_REL_TOL,
              "misdirected_rnn_rel_err": bad_err,
              "logprob_max_abs_err": lp_err,
              "argmax_agreement": agree, "argmax_floor": ARGMAX_FLOOR}
    print(json.dumps(result), flush=True)
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from deepspeech_tpu_torch.ops import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    card = smi.splitlines()[0]
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    built = _build.build(_build.all_sources())
    print(json.dumps({"built": sorted(built),
                      "build_seconds": time.perf_counter() - t0}),
          flush=True)

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    entries = kernel_phase(gen)
    entries[0]["launches"] = path_phase("ds2_small", 3)
    entries[1]["launches"] = path_phase("ds2_streaming", 5)
    for e in entries:
        _require(e["launches"] > 0, f"{e['name']} never launched")
    print(json.dumps({"kernels": entries, "card": card}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
