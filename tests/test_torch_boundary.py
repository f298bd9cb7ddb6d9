"""The port stands alone: no JAX, no flax, nothing of deepspeech_tpu,
and its entry points refuse to run on the CPU unless asked."""

import ast
import os
import subprocess
import sys

import pytest
import torch

from deepspeech_tpu_torch import resolve_device
from deepspeech_tpu_torch.config import apply_overrides, get_config
from deepspeech_tpu_torch.data import CharTokenizer
from deepspeech_tpu_torch.data import SyntheticPipeline
from deepspeech_tpu_torch.infer import Inferencer
from deepspeech_tpu_torch.ops import ctc
from deepspeech_tpu_torch.ops.gru import gru_bwd, gru_fwd
from deepspeech_tpu_torch.streaming import StreamingBeamDecoder
from deepspeech_tpu_torch.train import Trainer

# One CPU thread for torch: parallel test workers share the machine's
# cores, and a thread pool in each worker oversubscribes them.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The child's torch (OpenMP, MKL) holds to one thread, as this process does.
ONE_THREAD = {**os.environ, "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "deepspeech_tpu"}


def _port_sources():
    pkg = os.path.join(ROOT, "deepspeech_tpu_torch")
    for d, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def _imported_roots(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


# Modules whose JAX counterparts are jax-free or half so, which the port
# keeps its own copies of; each must be among the sources checked.
OWN_COPIES = ("deepspeech_tpu_torch/utils/quantize.py",
              "deepspeech_tpu_torch/serving/ladder.py",
              "deepspeech_tpu_torch/config.py",
              "deepspeech_tpu_torch/data/infer_bucket.py",
              "deepspeech_tpu_torch/utils/cache.py",
              "deepspeech_tpu_torch/obs/postmortem_link.py",
              "deepspeech_tpu_torch/obs/context.py",
              "deepspeech_tpu_torch/obs/timeline.py",
              "deepspeech_tpu_torch/obs/slo.py",
              "deepspeech_tpu_torch/resilience/postmortem.py",
              "deepspeech_tpu_torch/resilience/retry.py",
              "deepspeech_tpu_torch/resilience/faults.py",
              "deepspeech_tpu_torch/resilience/brownout.py",
              "deepspeech_tpu_torch/serving/registry.py",
              "deepspeech_tpu_torch/serving/replica.py",
              "deepspeech_tpu_torch/serving/pool.py",
              "deepspeech_tpu_torch/serving/scheduler.py",
              "deepspeech_tpu_torch/serving/migration.py",
              "deepspeech_tpu_torch/serving/tenancy.py",
              "deepspeech_tpu_torch/serving/rescoring.py",
              "deepspeech_tpu_torch/serving/rollout.py",
              "deepspeech_tpu_torch/serving/autoscale.py",
              "deepspeech_tpu_torch/serving/trafficmodel.py",
              "deepspeech_tpu_torch/obs/status.py",
              "deepspeech_tpu_torch/decode/ngram.py",
              "deepspeech_tpu_torch/decode/hashed_lm.py",
              "deepspeech_tpu_torch/decode/beam_host.py",
              "deepspeech_tpu_torch/native.py")


def test_no_jax_or_reference_imports():
    sources = {os.path.relpath(p, ROOT) for p in _port_sources()}
    assert set(OWN_COPIES) <= sources
    bad = [(os.path.relpath(p, ROOT), m) for p in _port_sources()
           for m in _imported_roots(p) if m in FORBIDDEN]
    assert not bad, bad


def test_import_leaves_jax_unloaded():
    code = ("import sys, deepspeech_tpu_torch.infer, "
            "deepspeech_tpu_torch.bridge, deepspeech_tpu_torch.train, "
            "deepspeech_tpu_torch.utils.quantize, "
            "deepspeech_tpu_torch.serving.ladder, "
            "deepspeech_tpu_torch.profile_infer, "
            "deepspeech_tpu_torch.serving, deepspeech_tpu_torch.serve, "
            "deepspeech_tpu_torch.resilience, deepspeech_tpu_torch.obs, "
            "deepspeech_tpu_torch.utils.cache, deepspeech_tpu_torch.decode, "
            "deepspeech_tpu_torch.native, "
            "deepspeech_tpu_torch.serving.tenancy, "
            "deepspeech_tpu_torch.serving.rescoring, "
            "deepspeech_tpu_torch.serving.rollout, "
            "deepspeech_tpu_torch.serving.autoscale, "
            "deepspeech_tpu_torch.serving.trafficmodel, "
            "deepspeech_tpu_torch.obs.status; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{sorted(FORBIDDEN)!r}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env=ONE_THREAD)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_entry_points_need_cuda_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        Inferencer(get_config("ds2_small"), CharTokenizer.english(),
                   params={}, batch_stats={})
    cfg = apply_overrides(get_config("ds2_small"),
                          {"train.checkpoint_dir": ""})
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(cfg, SyntheticPipeline(cfg, 1), CharTokenizer.english())
    with pytest.raises(RuntimeError, match="CUDA"):
        StreamingBeamDecoder(beam_width=4)
    assert resolve_device("cpu") == torch.device("cpu")


def test_gru_fwd_runs_plain_only_for_cpu_tensors():
    """A tensor on another device never reaches the plain version."""
    t, b, h = 2, 1, 4
    args = [torch.zeros(t, b, 3 * h, device="meta"),
            torch.ones(t, b, device="meta"),
            torch.zeros(1, h, 3 * h, device="meta"),
            torch.zeros(1, 3 * h, device="meta")]
    with pytest.raises(ValueError, match="cpu or cuda"):
        gru_fwd(*args)
    ys, hfin = gru_fwd(*[torch.zeros_like(a, device="cpu") for a in args])
    assert ys.shape == (1, t, b, h) and hfin.shape == (1, b, h)


def test_new_kernels_run_plain_only_for_cpu_tensors():
    """gru_bwd, ctc_alpha and ctc_beta: a tensor on another device never
    reaches the plain version."""
    t, b, h = 2, 1, 4
    gru_args = [torch.zeros(t, b, 3 * h), torch.ones(t, b),
                torch.zeros(1, h, 3 * h), torch.zeros(1, 3 * h),
                torch.zeros(1, t, b, h), torch.zeros(1, t, b, h)]
    with pytest.raises(ValueError, match="cpu or cuda"):
        gru_bwd(*[a.to("meta") for a in gru_args])
    dxp, dgates = gru_bwd(*gru_args)
    assert dxp.shape == dgates.shape == (1, t, b, 3 * h)
    prep = ctc.prepare(torch.zeros(b, t, 5), torch.ones(b, 1, dtype=torch.int32),
                       torch.full((b,), t), torch.ones(b, dtype=torch.int32))
    with pytest.raises(ValueError, match="cpu or cuda"):
        ctc.ctc_alpha(*[a.to("meta") for a in prep], tape=True)
    loglik, tape = ctc.ctc_alpha(*prep, tape=True)
    with pytest.raises(ValueError, match="cpu or cuda"):
        ctc.ctc_beta(*[a.to("meta") for a in prep], tape.to("meta"),
                     loglik.to("meta"))
    assert ctc.ctc_beta(*prep, tape, loglik).shape == (b, t, 3)
