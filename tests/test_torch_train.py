"""The port's training path (deepspeech_tpu_torch/train.py) against the
JAX package's ``make_train_step``, from one bridged init and one batch,
in float32, at a shrunk width (H=24, 2 GRU layers, 4 conv channels).

On the CPU the JAX step runs its oracles (the XLA scan GRU and the jnp
CTC) and the port its plain versions; the kernels are held to those
plain versions on the card by chip_smoke.py. Tolerances: gradients and
parameters after a step 1e-4 relative and 1e-5 absolute (the JAX
Pallas gradient tests' own), BN running statistics and the step's loss
and gradient norm 1e-5 relative.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deepspeech_tpu.config import apply_overrides as jax_apply_overrides
from deepspeech_tpu.config import get_config as jax_get_config
from deepspeech_tpu.models import create_model as jax_create_model
from deepspeech_tpu.ops import ctc_loss_mean as jax_ctc_loss_mean
from deepspeech_tpu.parallel import make_mesh
from deepspeech_tpu.train import TrainState
from deepspeech_tpu.train import make_lr_schedule as jax_lr_schedule
from deepspeech_tpu.train import make_optimizer as jax_make_optimizer
from deepspeech_tpu.train import make_train_step, state_shardings
from deepspeech_tpu_torch.bridge import from_flax, init_params, to_flax
from deepspeech_tpu_torch.config import apply_overrides, get_config
from deepspeech_tpu_torch.data import CharTokenizer, SyntheticPipeline
from deepspeech_tpu_torch.data.synthetic import synthetic_batch
from deepspeech_tpu_torch.models import DeepSpeech2
from deepspeech_tpu_torch.ops.ctc import ctc_loss_mean
from deepspeech_tpu_torch.train import (Trainer, check_supported,
                                        clip_by_global_norm,
                                        make_lr_schedule)

# One CPU thread for torch: parallel test workers share the machine's
# cores, and a thread pool in each worker oversubscribes them.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The child's torch (OpenMP, MKL) holds to one thread, as this process does.
ONE_THREAD = {**os.environ, "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}
SMALL = {"model.rnn_hidden": "24", "model.rnn_layers": "2",
         "model.conv_channels": "4,4", "model.dtype": "float32",
         "data.batch_size": "4", "train.checkpoint_dir": "",
         "train.warmup_steps": "2", "train.grad_clip_norm": "50"}
OPTS = {"sgd": {"train.optimizer": "sgd", "train.learning_rate": "0.001"},
        "adamw": {"train.optimizer": "adamw", "train.learning_rate": "0.0001",
                  "train.weight_decay": "0.01"}}
RTOL, ATOL = 1e-4, 1e-4


def _configs(preset, over):
    over = dict(SMALL, **over)
    return (jax_apply_overrides(jax_get_config(preset), over),
            apply_overrides(get_config(preset), over))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _assert_trees_close(got, ref, rtol=RTOL, atol=ATOL):
    """Each leaf within ``rtol`` of itself plus ``atol`` times the
    leaf's largest magnitude: f32 sums over a batch's frames land a few
    ulps of the largest term apart in the two frameworks."""
    got, ref = _flat(got), _flat(ref)
    assert sorted(got) == sorted(ref)
    for k in ref:
        scale = max(float(np.abs(ref[k]).max()), 1.0)
        np.testing.assert_allclose(got[k], ref[k], rtol=rtol,
                                   atol=atol * scale, err_msg=k)


def _setup(preset, opt="sgd", seed=0):
    """Configs, one bridged init (flax trees) and one synthetic batch of
    ragged lengths with labels."""
    jcfg, tcfg = _configs(preset, OPTS[opt])
    params, stats = init_params(tcfg, torch.Generator().manual_seed(seed))
    batch, _ = synthetic_batch(tcfg, 4, 48, 5, seed=seed,
                               frames_per_label=6)
    batch["feat_lens"][1:] = [40, 31, 22]
    return jcfg, tcfg, params, stats, batch


def _jax_step(jcfg, params, stats, batch, n_steps, steps_per_epoch=1):
    mesh = make_mesh((1, 1))
    model = jax_create_model(jcfg.model, mesh=mesh)
    opt = jax_make_optimizer(jcfg, steps_per_epoch)
    jparams = jax.tree.map(jnp.asarray, params)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=jparams,
                       batch_stats=jax.tree.map(jnp.asarray, stats),
                       opt_state=opt.init(jparams))
    sh = state_shardings(mesh, state)
    step = make_train_step(jcfg, model, opt, mesh, sh,
                           lr_schedule=jax_lr_schedule(jcfg,
                                                       steps_per_epoch))
    state = jax.device_put(state, sh)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    metrics = []
    for _ in range(n_steps):
        state, m = step(state, jbatch)
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


@pytest.mark.parametrize("preset", ["ds2_small", "ds2_streaming"])
def test_gradients_and_bn_stats_match_jax(preset):
    """One forward in train mode and one backward: every parameter's
    gradient and the updated BN running statistics."""
    jcfg, tcfg, params, stats, batch = _setup(preset)
    model = jax_create_model(jcfg.model)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_of(p):
        (logits, lens), mut = model.apply(
            {"params": p, "batch_stats": stats}, jb["features"],
            jb["feat_lens"], train=True, mutable=["batch_stats"])
        return (jax_ctc_loss_mean(logits, jb["labels"], lens,
                                  jb["label_lens"]), mut["batch_stats"])

    (ref_loss, ref_stats), ref_grads = jax.jit(
        jax.value_and_grad(loss_of, has_aux=True))(params)

    port = DeepSpeech2(tcfg.model)
    port.load_state_dict(from_flax(params, stats))
    port.train()
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    logits, lens = port(tb["features"], tb["feat_lens"].long())
    loss = ctc_loss_mean(logits, tb["labels"], lens, tb["label_lens"])
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss),
                               rtol=1e-5)
    grads, _ = to_flax({k: p.grad for k, p in port.named_parameters()})
    _assert_trees_close(grads, ref_grads)
    _, got_stats = to_flax(port.state_dict())
    _assert_trees_close(got_stats, ref_stats, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("opt", ["sgd", "adamw"])
def test_two_train_steps_match_jax(opt):
    """Parameters, BN statistics, loss and gradient norm after two steps
    on one batch (the second step sees the first's momentum)."""
    jcfg, tcfg, params, stats, batch = _setup("ds2_small", opt)
    ref_state, ref_metrics = _jax_step(jcfg, params, stats, batch, 2)
    pipe = SyntheticPipeline(tcfg, 4)
    trainer = Trainer(tcfg, pipe, CharTokenizer.english(), device="cpu",
                      params=params, batch_stats=stats)
    got = [{k: float(v) for k, v in trainer.train_step(batch).items()}
           for _ in range(2)]
    for g, r in zip(got, ref_metrics):
        np.testing.assert_allclose(g["loss"], r["loss"], rtol=1e-5)
        np.testing.assert_allclose(g["grad_norm"], r["grad_norm"], rtol=1e-5)
    # The init's gradient norm is above the limit: the steps clip.
    assert got[0]["grad_norm"] > tcfg.train.grad_clip_norm
    got_params, got_stats = to_flax(trainer.model.state_dict())
    _assert_trees_close(got_params, ref_state.params)
    _assert_trees_close(got_stats, ref_state.batch_stats, rtol=1e-5,
                        atol=1e-6)


@pytest.mark.parametrize("scale", [0.5, 2.0])
def test_clip_matches_optax(scale):
    """Below the limit the gradients pass unchanged; at or above it they
    are scaled exactly as optax.clip_by_global_norm scales them."""
    rng = np.random.default_rng(3)
    leaves = [rng.normal(size=s).astype(np.float32)
              for s in ((3, 4), (5,), (2, 2, 2))]
    norm = float(np.sqrt(sum((x.astype(np.float64) ** 2).sum()
                             for x in leaves)))
    max_norm = norm / scale
    ref, _ = optax.clip_by_global_norm(max_norm).update(
        [jnp.asarray(x) for x in leaves], optax.EmptyState())
    got = [torch.from_numpy(x.copy()) for x in leaves]
    n = clip_by_global_norm(got, max_norm)
    np.testing.assert_allclose(float(n), norm, rtol=1e-6)
    for g, r, x in zip(got, ref, leaves):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6)
        if scale < 1:
            np.testing.assert_array_equal(g.numpy(), x)


def test_lr_schedule_matches_jax_across_epochs():
    over = {"train.warmup_steps": "5", "train.lr_anneal": "1.3",
            "train.learning_rate": "0.002"}
    jcfg, tcfg = _configs("ds2_small", over)
    ref = jax_lr_schedule(jcfg, 7)
    got = make_lr_schedule(tcfg, 7)
    for step in range(30):  # warmup, then epochs 0..4 at 7 steps each
        np.testing.assert_allclose(got(step), float(ref(jnp.asarray(step))),
                                   rtol=1e-6)


def test_loss_falls_on_one_batch():
    """A shrunk model overfits one synthetic batch on the CPU: 40 AdamW
    steps cut the loss by more than half."""
    _, tcfg = _configs("ds2_small", {"train.optimizer": "adamw",
                                     "train.learning_rate": "0.003",
                                     "train.warmup_steps": "1",
                                     "model.rnn_hidden": "32"})
    pipe = SyntheticPipeline(tcfg, 4, frames=64, label_len=6)
    trainer = Trainer(tcfg, pipe, CharTokenizer.english(), device="cpu")
    batch = pipe.peek()
    losses = [float(trainer.train_step(batch)["loss"]) for _ in range(40)]
    assert losses[-1] < 0.5 * losses[0], losses
    ev = trainer.evaluate()
    assert ev["n_utts"] == 4 and 0.0 <= ev["cer"]


def test_train_cli_ends_with_done():
    cmd = [sys.executable, "-m", "deepspeech_tpu_torch.train",
           "--config=dev_slice", "--synthetic=8", "--device=cpu",
           "--model.rnn_hidden=32", "--model.rnn_layers=2",
           "--data.batch_size=4", "--train.checkpoint_dir=",
           "--train.epochs=1"]
    out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                         timeout=300, env=ONE_THREAD)
    assert out.returncode == 0, out.stderr
    last = json.loads(out.stdout.strip().splitlines()[-1])
    assert last["event"] == "done" and last["steps"] == 2
    assert np.isfinite(last["loss"]) and np.isfinite(last["grad_norm"])


@pytest.mark.parametrize("over,match", [
    ({"train.guardian": "true"}, "slice 9"),
    ({"train.accum_steps": "2"}, "slice 5"),
    ({"train.mesh_shape": "2,1"}, "slice 5"),
    ({"train.zero_opt_sharding": "true"}, "slice 5"),
    ({"train.sequence_parallel": "true"}, "slice 9"),
    ({"train.objective": "rnnt"}, "slice 9"),
    ({"model.pipeline_stages": "2"}, "slice 9"),
    ({"train.tensorboard_dir": "tb"}, "slice 9"),
    ({"train.profile_dir": "prof"}, "slice 9"),
])
def test_unported_training_options_raise(over, match):
    cfg = apply_overrides(get_config("ds2_small"),
                          {"train.checkpoint_dir": "", **over})
    with pytest.raises(NotImplementedError, match=match):
        check_supported(cfg)
    with pytest.raises(NotImplementedError, match=match):
        Trainer(cfg, SyntheticPipeline(cfg, 1), CharTokenizer.english(),
                device="cpu")


def test_checkpoint_dir_builds_a_checkpoint_manager(tmp_path):
    cfg = apply_overrides(get_config("ds2_small"),
                          {"train.checkpoint_dir": str(tmp_path / "ck")})
    check_supported(cfg)
    trainer = Trainer(cfg, SyntheticPipeline(cfg, 1),
                      CharTokenizer.english(), device="cpu")
    assert trainer.ckpt.directory == str(tmp_path / "ck")
    trainer.maybe_restore()  # an empty directory: a fresh run
    assert (trainer.step, trainer.start_epoch) == (0, 0)


def test_manifest_training_raises_naming_its_slice():
    """Training on a manifest is ported; without a manifest or
    --synthetic the CLI says what it needs."""
    from deepspeech_tpu_torch.train import main

    with pytest.raises(SystemExit, match="data.train_manifest"):
        main(["--config=dev_slice", "--device=cpu",
              "--train.checkpoint_dir="])
