"""The port's CheckpointManager contract (the one JAX
``tests/test_resilience.py`` and ``tests/test_infer.py`` pin for the
orbax manager: keep-N, the walk past torn and rejected steps, the
last-good ring, checkpoint averaging), the Trainer's checkpoint cadence
and its mid-epoch resume, bit-identical to an uninterrupted run (the
port's mirror of JAX ``tests/test_train.py``'s resume test), and the
train/infer CLIs on a WAV manifest with checkpoints."""

import json
import logging
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from deepspeech_tpu_torch import bridge
from deepspeech_tpu_torch.checkpoint import (CheckpointManager,
                                             average_checkpoints)
from deepspeech_tpu_torch.config import apply_overrides, get_config
from deepspeech_tpu_torch.data import CharTokenizer, DataPipeline
from deepspeech_tpu_torch.infer import Inferencer, restore_params
from deepspeech_tpu_torch.train import Trainer
from test_torch_manifest_data import write_corpus

# One CPU thread for torch: parallel test workers share the machine's
# cores, and a thread pool in each worker oversubscribes them.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The child's torch (OpenMP, MKL) holds to one thread, as this process does.
ONE_THREAD = {**os.environ, "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}
# A tiny f32 ds2_small on one 1.3 s bucket: 16 utterances in batches
# of 4 are 4 steps an epoch, sorted in epoch 0 and shuffled after.
TINY = {"model.rnn_hidden": "16", "model.rnn_layers": "2",
        "model.conv_channels": "4,4", "model.dtype": "float32",
        "data.batch_size": "4", "data.bucket_frames": "130",
        "data.max_label_len": "24", "data.max_duration_s": "1.3",
        "data.augment": "true", "data.spec_augment": "true",
        "train.epochs": "2", "train.checkpoint_every_steps": "3",
        "train.keep_checkpoints": "5", "train.warmup_steps": "2",
        "train.log_every": "1000", "train.grad_clip_norm": "50"}
OPTS = {"sgd": {"train.optimizer": "sgd", "train.learning_rate": "0.001"},
        "adamw": {"train.optimizer": "adamw", "train.learning_rate": "0.001",
                  "train.weight_decay": "0.01"}}


class Quiet:
    def __init__(self):
        self.events = []

    def log(self, event, **fields):
        self.events.append((event, fields))


def _state(value, dtype=np.float32):
    return {"params": {"w": np.full((2, 3), value, dtype),
                       "sub": {"b": np.full((3,), value, dtype)}},
            "batch_stats": {"m": np.full((3,), value, np.float32)},
            "epoch": int(value)}


def _w(restored):
    return float(restored["params"]["w"][0, 0])


def test_keep_n_prunes_the_oldest(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"), keep=2)
    for s in (1, 2, 3):
        assert mgr.save(s, _state(s))
    mgr.wait()
    assert mgr.all_steps() == [2, 3] and mgr.latest_step() == 3
    assert not mgr.save(3, _state(9))  # not past the newest: skipped
    got = mgr.restore()
    assert got["step"] == 3 and got["epoch"] == 3 and _w(got) == 3.0
    assert sorted(os.listdir(tmp_path / "ck" / "3")) == ["meta.json",
                                                         "params.npz"]
    mgr.close()


def test_restore_falls_back_past_a_step_whose_files_were_deleted(
        tmp_path, caplog):
    mgr = CheckpointManager(str(tmp_path / "ck"), keep=3)
    mgr.save(1, _state(1.0))
    mgr.save(2, _state(2.0))
    mgr.wait()
    os.remove(tmp_path / "ck" / "2" / "params.npz")
    with caplog.at_level(logging.WARNING):
        got = mgr.restore()
    assert _w(got) == 1.0 and got["epoch"] == 1
    assert "step 2 failed to restore" in caplog.text
    with pytest.raises(FileNotFoundError):
        mgr.restore(strict=True)
    with pytest.raises(FileNotFoundError):
        mgr.restore(step=2)


def test_restore_raises_when_no_step_is_intact(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"))
    assert mgr.restore() is None  # nothing saved yet
    mgr.save(1, _state(1.0))
    mgr.wait()
    os.remove(tmp_path / "ck" / "1" / "meta.json")
    with pytest.raises(FileNotFoundError):
        mgr.restore()


def test_restore_walks_past_torn_and_rejected_steps(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"), keep=5)
    for s in (1, 2, 3):
        mgr.save(s, _state(float(s)))
    mgr.wait()
    shutil.rmtree(tmp_path / "ck" / "3")
    os.makedirs(tmp_path / "ck" / "3")   # a torn step: its files gone
    mgr.mark_rejected(2)
    assert _w(mgr.restore()) == 1.0      # 3 torn, 2 rejected -> 1
    mgr.close()
    mgr2 = CheckpointManager(str(tmp_path / "ck"), keep=5)
    assert mgr2.rejected_steps() == (2,)
    assert _w(mgr2.restore()) == 1.0
    assert _w(mgr2.restore(step=2)) == 2.0  # an explicit step may name it


def test_last_good_ring_is_bounded_and_newest_first(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"), keep=2, last_good_keep=2)
    assert mgr.restore_last_good() is None
    live = torch.zeros(2)
    for s in (4, 8, 12):
        live.fill_(float(s))
        mgr.save_last_good(s, {"w": live}, meta={"applied_len": s})
    assert mgr.last_good_steps() == (8, 12)
    step, state, meta = mgr.restore_last_good()
    live.fill_(-1.0)  # the ring holds copies
    assert step == 12 and meta == {"applied_len": 12}
    np.testing.assert_array_equal(state["w"].numpy(), 12.0)


def test_save_snapshots_the_state_before_it_returns(tmp_path):
    """The optimizer changes parameters and buffers in place right after
    a save: what is written is the state at the call."""
    mgr = CheckpointManager(str(tmp_path / "ck"))
    w = torch.ones(512, 512)
    opt = {"state": {0: {"momentum_buffer": torch.ones(4)}},
           "param_groups": [{"lr": 0.1, "params": [0]}]}
    mgr.save(1, {"params": {"w": w}, "opt_state": opt, "epoch": 0})
    w.add_(1.0)
    opt["state"][0]["momentum_buffer"].add_(1.0)
    opt["param_groups"][0]["lr"] = 9.0
    mgr.wait()
    got = mgr.restore()
    assert float(got["params"]["w"].max()) == 1.0
    assert float(got["opt_state"]["state"][0]["momentum_buffer"][0]) == 1.0
    assert got["opt_state"]["param_groups"][0]["lr"] == 0.1


def test_average_checkpoints_is_the_float64_mean(tmp_path):
    d = str(tmp_path / "ck")
    mgr = CheckpointManager(d, keep=5)
    rng = np.random.default_rng(0)
    saved = []
    for s in (1, 2, 3):
        st = {"params": {"w": rng.normal(size=(3, 4)).astype(np.float32),
                         "h": rng.normal(size=(5,)).astype(np.float16)},
              "batch_stats": {"m": np.full((2,), float(s), np.float32)}}
        mgr.save(s, st)
        saved.append(st)
    mgr.wait()
    for k, take in ((2, saved[1:]), (10, saved), (0, saved[2:])):
        params, stats = average_checkpoints(d, last_k=k)
        for leaf in ("w", "h"):
            want = (sum(t["params"][leaf].astype(np.float64) for t in take)
                    / len(take)).astype(take[0]["params"][leaf].dtype)
            assert params[leaf].dtype == want.dtype
            np.testing.assert_array_equal(params[leaf], want)
        np.testing.assert_array_equal(stats["m"], 3.0)  # the newest's
    p2, _ = restore_params(d, average_last=2)
    np.testing.assert_array_equal(p2["w"], average_checkpoints(d, 2)[0]["w"])
    with pytest.raises(FileNotFoundError):
        restore_params(str(tmp_path / "nothing"))


@pytest.fixture(scope="module")
def corpus16(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("wavs16"))
    return (write_corpus(root, 16, seed=11),
            write_corpus(root, 6, seed=12, name="eval"))


def _trainer(ckdir, manifest, opt):
    cfg = apply_overrides(get_config("ds2_small"),
                          {**TINY, **OPTS[opt],
                           "train.checkpoint_dir": str(ckdir)})
    tok = CharTokenizer.english()
    pipe = DataPipeline(cfg, tok, manifest)
    return Trainer(cfg, pipe, tok, logger=Quiet(), device="cpu")


_UNINTERRUPTED = {}


def _uninterrupted(tmp_path_factory, manifest, opt):
    """One uninterrupted 2-epoch run per optimizer (8 steps; saves at
    steps 3 and 6 every 3 steps, 4 and 8 at the epochs' ends)."""
    if opt not in _UNINTERRUPTED:
        d = tmp_path_factory.mktemp(f"full_{opt}") / "ck"
        t = _trainer(d, manifest, opt)
        t.fit()
        _UNINTERRUPTED[opt] = (t, d)
    return _UNINTERRUPTED[opt]


@pytest.mark.parametrize("opt", ["sgd", "adamw"])
@pytest.mark.parametrize("resume,epoch", [(3, 0), (6, 1)])
def test_midepoch_resume_is_bit_identical(tmp_path, tmp_path_factory,
                                          corpus16, opt, resume, epoch):
    """A fresh Trainer restores a mid-epoch step (epoch 0 sorted, or
    epoch 1 shuffled; both augmented), takes exactly the remaining
    batches, and ends with the uninterrupted run's parameters, BN
    statistics and optimizer state bit for bit."""
    full, full_dir = _uninterrupted(tmp_path_factory, corpus16[0], opt)
    assert full.step == 8 and full.ckpt.all_steps() == [3, 4, 6, 8]
    epochs = {s: json.load(open(full_dir / str(s) / "meta.json"))["epoch"]
              for s in (3, 4, 6, 8)}
    assert epochs == {3: 0, 4: 1, 6: 1, 8: 2}
    d = tmp_path / "ck"
    shutil.copytree(full_dir, d)
    for s in (4, 6, 8):
        if s > resume:
            shutil.rmtree(d / str(s))
    t = _trainer(d, corpus16[0], opt)
    t.maybe_restore()
    assert (t.step, t.start_epoch) == (resume, epoch)
    assert ("restore", {"step": resume, "epoch": epoch}) in t.logger.events
    ran, loaded = [], []
    real, load = t.train_step, t.pipeline._materialize
    t.train_step = lambda b: (ran.append(1), real(b))[1]
    t.pipeline._materialize = lambda plan, epoch=None: (
        loaded.append(epoch), load(plan, epoch))[1]
    t.fit()
    # The consumed batches are skipped unloaded.
    assert len(ran) == len(loaded) == 8 - resume and t.step == 8
    got, ref = t.model.state_dict(), full.model.state_dict()
    for k in ref:
        assert torch.equal(got[k], ref[k]), k
    gs, rs = t.optimizer.state_dict(), full.optimizer.state_dict()
    assert gs["param_groups"] == rs["param_groups"]
    for i in rs["state"]:
        for k, v in rs["state"][i].items():
            assert torch.equal(gs["state"][i][k], v), (i, k)
    # The resumed run saved the uninterrupted run's steps again.
    assert t.ckpt.all_steps() == [s for s in (3, 4, 6, 8)]
    p_full, _ = bridge.load_npz(str(full_dir / "8" / "params.npz"))
    p_res, _ = bridge.load_npz(str(d / "8" / "params.npz"))
    np.testing.assert_array_equal(p_full["head"]["kernel"],
                                  p_res["head"]["kernel"])


def test_default_checkpoint_dir_is_under_tmpdir(tmp_path, monkeypatch,
                                               corpus16):
    """A preset's default checkpoint_dir lies under $TMPDIR, so runs with
    temp directories of their own never share steps; a Trainer with it
    checkpoints there."""
    import tempfile

    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr(tempfile, "tempdir", None)
    cfg = apply_overrides(get_config("ds2_small"),
                          {**TINY, **OPTS["sgd"], "train.epochs": "1"})
    want = tmp_path / "deepspeech_tpu_ckpt"
    assert cfg.train.checkpoint_dir == str(want)
    tok = CharTokenizer.english()
    t = Trainer(cfg, DataPipeline(cfg, tok, corpus16[0]), tok,
                logger=Quiet(), device="cpu")
    t.fit()
    assert sorted(os.listdir(want)) == ["3", "4"]


def test_inferencer_restores_the_trainers_step(tmp_path_factory, corpus16):
    full, full_dir = _uninterrupted(tmp_path_factory, corpus16[0], "sgd")
    cfg = apply_overrides(full.cfg, {"train.checkpoint_dir": str(full_dir)})
    inf = Inferencer(cfg, CharTokenizer.english(), device="cpu")
    batch = next(iter(full.pipeline.eval_epoch()))[0]
    full.model.eval()
    with torch.no_grad():
        ref, _ = full.model(torch.from_numpy(batch["features"]),
                            torch.from_numpy(batch["feat_lens"]))
    lp, _ = inf.forward(batch["features"], batch["feat_lens"])
    assert torch.equal(lp, torch.log_softmax(ref, dim=-1))


def test_train_then_infer_cli_on_a_manifest(tmp_path, corpus16):
    train_m, eval_m = corpus16
    ck = str(tmp_path / "ck")
    over = [f"--{k}={v}" for k, v in TINY.items() if "augment" not in k]
    cmd = [sys.executable, "-m", "deepspeech_tpu_torch.train",
           "--config=dev_slice", "--device=cpu", *over,
           f"--data.train_manifest={train_m}",
           f"--data.eval_manifest={eval_m}", f"--train.checkpoint_dir={ck}"]
    out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                         timeout=300, env=ONE_THREAD)
    assert out.returncode == 0, out.stderr
    lines = [json.loads(ln) for ln in out.stdout.strip().splitlines()]
    assert lines[-1]["event"] == "done" and lines[-1]["steps"] == 8
    assert [ln["epoch"] for ln in lines if ln["event"] == "eval"] == [0, 1]
    assert sorted(os.listdir(ck)) == ["3", "4", "6", "8"]
    cmd = [sys.executable, "-m", "deepspeech_tpu_torch.infer",
           "--config=dev_slice", f"--checkpoint-dir={ck}",
           f"--manifest={eval_m}", "--average-last=2", "--device=cpu",
           *[o for o in over if o.split("=")[0].startswith(("--model",
                                                            "--data"))]]
    out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                         timeout=300, env=ONE_THREAD)
    assert out.returncode == 0, out.stderr
    lines = [json.loads(ln) for ln in out.stdout.strip().splitlines()]
    assert lines[-1]["event"] == "done" and lines[-1]["n_utts"] == 6
    assert sum(ln["event"] == "utt" for ln in lines) == 6
