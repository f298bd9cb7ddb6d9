"""Checkpoint import: a step the JAX trainer's orbax manager wrote,
read by the port without JAX or orbax (``import_orbax_step``), served by
the port's ``Inferencer`` and converted to an ``.npz`` for a host
without ``tensorstore``. Inferencer tolerance: log-probs within 1e-4 in
float32 and identical greedy transcripts, as the other Inferencer
parity tests hold."""

import dataclasses
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from deepspeech_tpu.config import get_config as jax_get_config
from deepspeech_tpu.data import CharTokenizer as JaxCharTokenizer
from deepspeech_tpu.infer import Inferencer as JaxInferencer
from deepspeech_tpu.infer import restore_params as jax_restore_params
from deepspeech_tpu.train import Trainer as JaxTrainer
from deepspeech_tpu.train import _SyntheticPipeline
from deepspeech_tpu.utils.logging import JsonlLogger
from deepspeech_tpu_torch import bridge
from deepspeech_tpu_torch.checkpoint import CheckpointManager
from deepspeech_tpu_torch.checkpoint_import import import_orbax_step
from deepspeech_tpu_torch.config import apply_overrides, get_config
from deepspeech_tpu_torch.data import CharTokenizer
from deepspeech_tpu_torch.data.synthetic import synthetic_batch
from deepspeech_tpu_torch.infer import Inferencer, restore_params

# One CPU thread for torch: parallel test workers share the machine's
# cores, and a thread pool in each worker oversubscribes them.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The child's torch (OpenMP, MKL) holds to one thread, as this process does.
ONE_THREAD = {**os.environ, "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}
OVER = {"model.rnn_hidden": "16", "model.rnn_layers": "2",
        "model.conv_channels": "4,4", "model.dtype": "float32",
        "data.batch_size": "4", "data.bucket_frames": "48",
        "data.max_label_len": "16"}


def _jax_cfg(ckdir):
    cfg = jax_get_config("dev_slice")
    return dataclasses.replace(
        cfg,
        model=dataclasses.replace(cfg.model, rnn_hidden=16, rnn_layers=2,
                                  dtype="float32", conv_channels=(4, 4)),
        data=dataclasses.replace(cfg.data, batch_size=4, bucket_frames=(48,),
                                 max_label_len=16),
        train=dataclasses.replace(cfg.train, checkpoint_dir=ckdir,
                                  warmup_steps=2, learning_rate=1e-3,
                                  log_every=50, epochs=2,
                                  checkpoint_every_steps=1,
                                  keep_checkpoints=5, mesh_shape=(1, 1)))


@pytest.fixture(scope="module")
def jax_ckpt(tmp_path_factory):
    """The JAX Trainer's checkpoints of a tiny model: 2 epochs of 2
    steps, one step saved every step (1-4)."""
    d = str(tmp_path_factory.mktemp("jax") / "ck")
    cfg = _jax_cfg(d)
    pipe = _SyntheticPipeline(cfg, n_utts=8, frames=48, label_len=4)
    t = JaxTrainer(cfg, pipe, JaxCharTokenizer.english(),
                   logger=JsonlLogger(echo=False))
    t.fit()
    t.ckpt.wait()
    assert t.ckpt.all_steps() == [1, 2, 3, 4]
    return d


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _assert_trees_equal(got, ref):
    got, ref = _flat(got), _flat(ref)
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_import_without_jax_equals_jax_restore(jax_ckpt, tmp_path):
    """In a process that never imports jax or orbax, the newest step's
    arrays equal the JAX ``restore_params``'s, with its step and epoch."""
    out = str(tmp_path / "imported.npz")
    code = (
        "import sys, json; "
        "from deepspeech_tpu_torch.checkpoint_import import "
        "import_orbax_step; "
        "from deepspeech_tpu_torch.bridge import save_npz; "
        f"p, b, step, epoch = import_orbax_step({jax_ckpt!r}); "
        f"save_npz({out!r}, p, b); "
        "print(json.dumps({'step': step, 'epoch': epoch, 'mods': sorted("
        "m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'deepspeech_tpu'))}))")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env=ONE_THREAD)
    assert res.returncode == 0, res.stderr
    info = json.loads(res.stdout.strip().splitlines()[-1])
    # Step 4 ends epoch 1; its every-step save came first, with epoch 1.
    assert info == {"step": 4, "epoch": 1, "mods": []}
    params, stats = bridge.load_npz(out)
    ref_params, ref_stats = jax_restore_params(jax_ckpt)
    _assert_trees_equal(params, ref_params)
    _assert_trees_equal(stats, ref_stats)
    got = import_orbax_step(jax_ckpt, step=2)
    assert got[2:] == (2, 0)
    _assert_trees_equal(restore_params(jax_ckpt)[0], ref_params)
    _assert_trees_equal(restore_params(jax_ckpt, average_last=2)[0],
                        jax_restore_params(jax_ckpt, average_last=2)[0])


def test_port_inferencer_on_a_jax_checkpoint(jax_ckpt):
    tcfg = apply_overrides(get_config("dev_slice"),
                           {**OVER, "train.checkpoint_dir": jax_ckpt})
    batch, _ = synthetic_batch(tcfg, 4, 48, 4, seed=1)
    inf = Inferencer(tcfg, CharTokenizer.english(), device="cpu")
    ref = JaxInferencer(_jax_cfg(jax_ckpt), JaxCharTokenizer.english())
    lp, lens = inf.forward(batch["features"], batch["feat_lens"])
    ref_lp, ref_lens = ref._forward(ref.params, ref.batch_stats,
                                    batch["features"], batch["feat_lens"])
    np.testing.assert_array_equal(lens.numpy(), np.asarray(ref_lens))
    np.testing.assert_allclose(lp.numpy(), np.asarray(ref_lp), rtol=0,
                               atol=1e-4)
    assert inf.decode_batch(batch) == ref.decode_batch(batch)


def test_torn_newest_step_falls_back_as_jax_does(jax_ckpt, tmp_path):
    d = str(tmp_path / "ck")
    shutil.copytree(jax_ckpt, d)
    shutil.rmtree(os.path.join(d, "4", "default"))
    params, stats, step, epoch = import_orbax_step(d)
    assert (step, epoch) == (3, 1)
    _assert_trees_equal(params, jax_restore_params(d)[0])
    with pytest.raises(FileNotFoundError, match="partial or corrupt"):
        import_orbax_step(d, step=4)
    with open(os.path.join(d, "rejected_steps.json"), "w") as fh:
        json.dump([3], fh)
    assert import_orbax_step(d)[2] == 2


def test_converter_cli_writes_what_infer_params_reads(jax_ckpt, tmp_path):
    out = str(tmp_path / "x.npz")
    res = subprocess.run(
        [sys.executable, "-m", "deepspeech_tpu_torch.checkpoint_import",
         f"--checkpoint-dir={jax_ckpt}", f"--out={out}", "--step=3"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env=ONE_THREAD)
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout.strip().splitlines()[-1])["step"] == 3
    _assert_trees_equal(bridge.load_npz(out)[0],
                        import_orbax_step(jax_ckpt, step=3)[0])
    res = subprocess.run(
        [sys.executable, "-m", "deepspeech_tpu_torch.infer",
         "--config=dev_slice", "--synthetic=4", f"--params={out}",
         "--device=cpu", *[f"--{k}={v}" for k, v in OVER.items()]],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env=ONE_THREAD)
    assert res.returncode == 0, res.stderr
    last = json.loads(res.stdout.strip().splitlines()[-1])
    assert last["event"] == "done" and last["n_utts"] == 4


def test_without_tensorstore_restore_names_the_converter(jax_ckpt,
                                                         monkeypatch):
    monkeypatch.setitem(sys.modules, "tensorstore", None)
    with pytest.raises(ImportError, match="checkpoint_import"):
        restore_params(jax_ckpt)
    with pytest.raises(ValueError, match="orbax"):
        CheckpointManager(jax_ckpt)
