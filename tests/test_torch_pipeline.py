"""Pipeline-parallel training (item 14c) on gloo worlds of CPU processes
against the JAX package's pipelined model and ``make_train_step`` on
``(data, pipe, model)`` meshes of its 8 virtual CPU devices, at
``tests/test_pipeline_pp.py``'s size (dev_slice, 3 layers of 32 units,
a batch of 8 at 64 frames).

Three worlds are spawned once for the module
(``tests/test_torch_pipeline_worker.py``, a ``file://`` store in a temp
directory, each child under its own 240 s timeout): ``(1, 2, 1)`` on two
ranks, ``(2, 2, 1)`` on four and ``(1, 3, 1)`` on three (4 layers, one a
stage, so that a hop between middle stages runs); the tests hold what
each case left. The model cases run the same seeded weights (BN
statistics, scales and biases away from their init) and inputs as JAX.
Tolerances: eval logits 1e-5; in train mode the logits within 1e-5 and
the loss within 1e-6 relative (the loss being each side's logits'
mean square taken in f64: JAX's own f32 mean in its jitted step is
1.0e-6 off that at M = 2, its summation order's noise), each gradient
within ``test_torch_seqpar_train.py``'s rtol 1e-4
and atol 5e-4 of the leaf's largest magnitude, the BN statistics within
1e-5; a ``Trainer``'s parameters, BN statistics and momentum within 1e-5
of each leaf's largest magnitude, as ``test_torch_dp.py`` holds a step;
bf16 the loss within 1e-2 relative.
"""

import functools
import json
import os
import subprocess
import sys
import time
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from deepspeech_tpu.config import apply_overrides as jax_apply_overrides
from deepspeech_tpu.config import get_config as jax_get_config
from deepspeech_tpu.data import CharTokenizer as JaxCharTokenizer
from deepspeech_tpu.models import create_model as jax_create_model
from deepspeech_tpu.parallel import make_mesh as jax_make_mesh
from deepspeech_tpu.parallel import mesh as jax_mesh
from deepspeech_tpu.train import Trainer as JaxTrainer
from deepspeech_tpu.train import TrainState, _SyntheticPipeline
from deepspeech_tpu.train import make_lr_schedule as jax_lr_schedule
from deepspeech_tpu.train import make_optimizer as jax_make_optimizer
from deepspeech_tpu.train import make_train_step, state_shardings
from deepspeech_tpu.utils.logging import JsonlLogger
from deepspeech_tpu_torch import bridge
from deepspeech_tpu_torch.config import apply_overrides
from deepspeech_tpu_torch.data import CharTokenizer
from deepspeech_tpu_torch.decode.greedy import greedy_decode, ids_to_texts
from deepspeech_tpu_torch.infer import Inferencer
from deepspeech_tpu_torch.metrics import char_errors, word_errors
from deepspeech_tpu_torch.models.ds2 import DeepSpeech2
from deepspeech_tpu_torch.parallel import Mesh, make_mesh, mesh as port_mesh
from deepspeech_tpu_torch.train import Trainer, check_supported

import test_torch_pipeline_worker as worker

# One CPU thread for torch: parallel test workers share the machine's
# cores, and a thread pool in each worker oversubscribes them.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD_TIMEOUT_S = 240
CHILD_ENV = {**os.environ, "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1",
             "PYTHONPATH": ROOT}
WORLDS = ((1, 2, 1), (2, 2, 1), (1, 3, 1))
EVAL_TOL = 1e-5
LOSS_RTOL = 1e-6
GRAD_RTOL, GRAD_ATOL = 1e-4, 5e-4
STATS_TOL = 1e-5
STEP_TOL = 1e-5
BF16_LOSS_RTOL = 1e-2


def _inputs():
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(8, worker.FRAMES, 161)).astype(np.float32)
    lens = rng.integers(worker.FRAMES // 2, worker.FRAMES + 1,
                        size=8).astype(np.int32)
    lens[0] = worker.FRAMES
    return feats, lens


@functools.lru_cache(maxsize=None)
def _weights(case):
    """A model case's weights: the port's seeded init with every BN
    scale, bias and statistic and every bias moved off its init."""
    _, over, _ = worker.CASES[case]
    params, stats = bridge.init_params(worker.config(over),
                                       torch.Generator().manual_seed(1))
    rng = np.random.default_rng(zlib.crc32(case.encode()))

    def move(tree, fn):
        return bridge._nest({k: fn(k, v) for k, v in
                             bridge._flatten(tree).items()})

    def param(key, v):
        leaf = key.rsplit(".", 1)[-1]
        if leaf in ("scale", "bn_scale"):
            return (v + 0.2 * rng.normal(size=v.shape)).astype(np.float32)
        if "bias" in leaf or leaf.startswith("bh_"):
            return (0.1 * rng.normal(size=v.shape)).astype(np.float32)
        return v

    def stat(key, v):
        if key.endswith("mean"):
            return (0.2 * rng.normal(size=v.shape)).astype(np.float32)
        return rng.uniform(0.5, 1.5, size=v.shape).astype(np.float32)

    return move(params, param), move(stats, stat)


class World:
    """The spawned worlds; ``result`` waits for them once."""

    def __init__(self, root, procs):
        self.root, self.procs, self.done = root, procs, False

    def wait(self):
        if self.done:
            return
        deadline = time.monotonic() + CHILD_TIMEOUT_S
        errors = []
        for name, p in self.procs:
            try:
                _, err = p.communicate(
                    timeout=max(deadline - time.monotonic(), 1))
            except subprocess.TimeoutExpired:
                for _, q in self.procs:
                    q.kill()
                pytest.fail(f"{name} did not finish in {CHILD_TIMEOUT_S} s")
            if p.returncode != 0:
                errors.append(f"{name} exited {p.returncode}:\n{err[-3000:]}")
        self.done = True
        assert not errors, "\n".join(errors)

    def result(self, case, rank=0):
        self.wait()
        base = os.path.join(self.root, f"{case}_{rank}")
        with np.load(base + ".npz") as z:
            arrays = dict(z)
        with open(base + ".json") as fh:
            return arrays, json.load(fh)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("pp"))
    feats, lens = _inputs()
    np.savez(os.path.join(root, "inputs.npz"), features=feats,
             feat_lens=lens)
    for case, (_, _, kind) in worker.CASES.items():
        if kind != "trainer":
            bridge.save_npz(os.path.join(root, f"w_{case}.npz"),
                            *_weights(case))
    procs = []
    for shape in WORLDS:
        n = int(np.prod(shape))
        tag = ",".join(map(str, shape))
        url = "file://" + os.path.join(root, f"store{tag}")
        for r in range(n):
            procs.append((f"world {tag} rank {r}", subprocess.Popen(
                [sys.executable, os.path.join(ROOT, "tests",
                                              "test_torch_pipeline_worker.py"),
                 str(r), str(n), url, root, tag],
                cwd=ROOT, env=CHILD_ENV, stdout=subprocess.DEVNULL,
                stderr=subprocess.PIPE, text=True)))
    w = World(root, procs)
    try:
        yield w
    finally:
        for _, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


# -- the JAX side ----------------------------------------------------------

def _jax_config(over):
    return jax_apply_overrides(jax_get_config("dev_slice"),
                               dict(worker.BASE, **over))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v, dtype=np.float32)
    return out


@functools.lru_cache(maxsize=None)
def _jax_model(case, sequential=False):
    """JAX's pipelined model on the case's mesh (``sequential``: with no
    mesh) on the case's weights and inputs: the eval logits, or the
    mean(logits^2) loss, its gradients and the BN statistics after it."""
    shape, over, kind = worker.CASES[case]
    jcfg = _jax_config(over)
    params, stats = _weights(case)
    variables = {"params": jax.tree.map(jnp.asarray, params),
                 "batch_stats": jax.tree.map(jnp.asarray, stats)}
    feats, lens = _inputs()
    mesh = None if sequential else jax_make_mesh(shape)
    model = jax_create_model(jcfg.model, mesh=mesh)
    f = jnp.asarray(feats)
    if mesh is not None:
        f = jax.device_put(f, NamedSharding(mesh, P("data")))
    lens = jnp.asarray(lens)
    if kind == "eval":
        out, _ = jax.jit(lambda v, x, n: model.apply(v, x, n, train=False))(
            variables, f, lens)
        return {"logits": np.asarray(out)}

    def loss(p):
        (logits, _), mut = model.apply(
            {"params": p, "batch_stats": variables["batch_stats"]}, f, lens,
            train=True, mutable=["batch_stats"])
        logits = logits.astype(jnp.float32)
        return jnp.mean(logits ** 2), (logits, mut)

    (_, (logits, mut)), grads = jax.jit(
        jax.value_and_grad(loss, has_aux=True))(variables["params"])
    logits = np.asarray(logits)
    return {"loss": _loss(logits), "logits": logits, "grads": _flat(grads),
            "batch_stats": _flat(mut["batch_stats"])}


def _loss(logits):
    """mean(logits^2), in f64."""
    return float(np.mean(np.asarray(logits, np.float64) ** 2))


@functools.lru_cache(maxsize=None)
def _jax_trainer(case):
    """``make_train_step`` on the case's mesh over the worker's batches,
    from the same bridged init: (state, metrics)."""
    shape, over, _ = worker.CASES[case]
    jcfg = _jax_config(over)
    tcfg = worker.config(over)
    params, stats = bridge.init_params(tcfg, torch.Generator().manual_seed(0))
    batches = worker.pipeline(tcfg).batches
    mesh = jax_make_mesh(shape)
    model = jax_create_model(jcfg.model, mesh=mesh)
    opt = jax_make_optimizer(jcfg, len(batches))
    jparams = jax.tree.map(jnp.asarray, params)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=jparams,
                       batch_stats=jax.tree.map(jnp.asarray, stats),
                       opt_state=opt.init(jparams))
    sh = state_shardings(mesh, state)
    step = make_train_step(jcfg, model, opt, mesh, sh,
                           lr_schedule=jax_lr_schedule(jcfg, len(batches)))
    state = jax.device_put(state, sh)
    metrics = []
    for b in batches:
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


def _trace(state):
    """The SGD momentum (optax's ``trace``) of a JAX optimizer state."""
    def find(s):
        if hasattr(s, "trace"):
            return s.trace
        for attr in ("inner_state",):
            if hasattr(s, attr):
                return find(getattr(s, attr))
        if isinstance(s, (tuple, list)):
            for x in s:
                got = find(x)
                if got is not None:
                    return got
        return None

    return _flat(find(state.opt_state))


def _close(got, ref, tol, what):
    scale = max(float(np.abs(ref).max()), 1.0)
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol * scale,
                               err_msg=what)


def _same_on_every_rank(world, case, n):
    got, meta = world.result(case, 0)
    for r in range(1, n):
        other, _ = world.result(case, r)
        assert sorted(other) == sorted(got)
        for k in got:
            np.testing.assert_array_equal(other[k], got[k],
                                          err_msg=f"rank {r} {k}")
    return got, meta


def _check_grad_case(world, case, sequential=False):
    shape = worker.CASES[case][0]
    got, meta = _same_on_every_rank(world, case, int(np.prod(shape)))
    ref = _jax_model(case, sequential)
    np.testing.assert_allclose(got["logits"], ref["logits"], atol=EVAL_TOL,
                               rtol=EVAL_TOL)
    np.testing.assert_allclose(_loss(got["logits"]), ref["loss"],
                               rtol=LOSS_RTOL)
    for k, v in ref["grads"].items():
        scale = float(np.abs(v).max())
        np.testing.assert_allclose(got[f"grads/{k}"], v, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL * scale, err_msg=k)
    for k, v in ref["batch_stats"].items():
        np.testing.assert_allclose(got[f"batch_stats/{k}"], v,
                                   atol=STATS_TOL, err_msg=k)
    return got, meta


# -- eval ------------------------------------------------------------------

@pytest.mark.parametrize("case", ["eval_m1", "eval_m2", "eval_m4",
                                  "eval_nobn"])
def test_eval_logits_equal_jax_pipelined(world, case):
    """Eval mode on a (1, 2, 1) world runs the schedule forward-only on
    the running statistics: JAX's pipelined eval for M = 1, 2 and 4 and
    with the RNN BN off, the same logits on both ranks."""
    got, meta = _same_on_every_rank(world, case, 2)
    np.testing.assert_allclose(got["logits"], _jax_model(case)["logits"],
                               atol=EVAL_TOL, rtol=EVAL_TOL)
    assert meta["rows"]["wh_fw"] == 1


# -- train mode ------------------------------------------------------------

def test_train_m1_equals_jax_pipelined_and_sequential(world):
    """M = 1: the pipelined step is the sequential arithmetic (JAX's own
    claim, tests/test_pipeline_pp.py:80-109), held against both; and the
    port's one-process sequential oracle (no mesh) gives the pipe run's
    loss, logits, gradients and statistics bit for bit."""
    got, _ = _check_grad_case(world, "grad_m1")
    _check_grad_case(world, "grad_m1", sequential=True)
    _, over, _ = worker.CASES["grad_m1"]
    cfg = worker.config(over)
    model = DeepSpeech2(cfg.model)
    model.load_state_dict(bridge.from_flax(*_weights("grad_m1")))
    feats, lens = _inputs()
    model.train()
    logits, _ = model(torch.from_numpy(feats), torch.from_numpy(lens).long())
    loss = logits.float().square().mean()
    loss.backward()
    np.testing.assert_array_equal(got["loss"], loss.detach().numpy())
    np.testing.assert_array_equal(got["logits"], logits.detach().numpy())
    grads, _ = bridge.to_flax({n: p.grad for n, p in
                               model.named_parameters()})
    for k, v in _flat(grads).items():
        np.testing.assert_array_equal(got[f"grads/{k}"], v, err_msg=k)
    _, stats = bridge.to_flax(model.state_dict())
    for k, v in _flat(stats).items():
        np.testing.assert_array_equal(got[f"batch_stats/{k}"], v, err_msg=k)


@pytest.mark.parametrize("case", ["grad_m2", "grad_m4", "grad_lstm",
                                  "grad_nobn", "grad_uni"])
def test_train_matches_jax_pipelined(world, case):
    """M = 2 and M = 4 (> P), an LSTM, the RNN BN off and a
    unidirectional GRU: each microbatch normalized by its own statistics,
    the running ones updated once with their mean, gradients through the
    recomputed stages; against JAX's pipelined step."""
    _check_grad_case(world, case)


def test_bf16_train_every_stacked_layer_learns(world):
    """bf16 at M = 2: the loss within 1e-2 of JAX's, every gradient
    finite, and every stacked layer of both stages given a gradient."""
    got, _ = _same_on_every_rank(world, "grad_bf16", 2)
    ref = _jax_model("grad_bf16")
    np.testing.assert_allclose(_loss(got["logits"]), ref["loss"],
                               rtol=BF16_LOSS_RTOL)
    for k, v in got.items():
        if k.startswith("grads/"):
            assert np.all(np.isfinite(v)), k
            if k.startswith("grads/rnn_pipe/"):
                per_layer = np.abs(v).reshape(v.shape[0], -1).max(axis=1)
                assert per_layer.min() > 0, k
    assert sorted(k for k in got if k.startswith("grads/")) == sorted(
        f"grads/{k}" for k in ref["grads"])


def test_three_stages_hop_between_middle_stages(world):
    """(1, 3, 1) with 4 layers (one stacked layer a stage) at M = 4: the
    middle stage receives from the first and sends to the last, and the
    step matches JAX's pipelined one on 3 devices."""
    _, meta = _check_grad_case(world, "grad_p3")
    assert meta["rows"]["wh_fw"] == 1
    stages = {world.result("grad_p3", r)[1]["stage"] for r in range(3)}
    assert stages == {0, 1, 2}


# -- Trainer ---------------------------------------------------------------

def _check_trainer(world, case):
    shape = worker.CASES[case][0]
    got, meta = _same_on_every_rank(world, case, int(np.prod(shape)))
    state, ref_metrics = _jax_trainer(case)
    for g, r in zip(meta["metrics"], ref_metrics):
        np.testing.assert_allclose(g["loss"], r["loss"], rtol=STEP_TOL)
        np.testing.assert_allclose(g["grad_norm"], r["grad_norm"],
                                   rtol=STEP_TOL)
    for k, v in _flat(state.params).items():
        _close(got[f"params/{k}"], v, STEP_TOL, k)
    for k, v in _flat(state.batch_stats).items():
        _close(got[f"batch_stats/{k}"], v, STATS_TOL, k)
    trace = _trace(state)
    names = {bridge.flax_path(k[len("opt/"):-len("/momentum_buffer")],
                              v.shape)[0]: (k, v) for k, v in got.items()
             if k.endswith("/momentum_buffer")}
    assert sorted(names) == sorted(trace)
    for path, ref in trace.items():
        key, v = names[path]
        if v.ndim == 4:
            v = v.transpose(2, 3, 1, 0)
        _close(v, ref, STEP_TOL, key)
    return got, meta


@pytest.mark.parametrize("case", ["trainer_m2", "trainer_accum",
                                  "trainer_dp"])
def test_trainer_steps_match_make_train_step(world, case):
    """Two ``Trainer`` steps (CTC, SGD with Nesterov momentum, the clip
    active) against JAX's ``make_train_step`` on the same mesh: (1, 2, 1)
    at M = 2, with ``accum_steps=2`` (the schedule once an accumulation
    microbatch), and (2, 2, 1), where each stage's BN statistics are
    taken over the data group and the gradients all-reduced over it. The
    global norm sums the stages' squares over the pipe group, so the
    loss, the norm and every rank's state agree bit for bit."""
    got, meta = _check_trainer(world, case)
    assert all(m["grad_norm"] > float(worker.BASE["train.grad_clip_norm"])
               for m in meta["metrics"])


def test_each_rank_holds_its_stage(world):
    """Parameters, BN statistics and optimizer state of the stacked
    layers: L/P = 1 layer a rank, stage p holding layer p."""
    for r in range(2):
        _, meta = world.result("trainer_m2", r)
        assert meta["stage"] == r
        assert set(meta["rows"].values()) == {1}
        assert meta["rows"].keys() >= {"wh_fw", "mean", "var"}
        assert set(meta["opt_rows"].values()) == {1}
    for r in range(4):
        _, meta = world.result("trainer_dp", r)
        assert meta["stage"] == r % 2


def test_evaluate_scores_each_row_once(world):
    """``evaluate`` on a (1, 2, 1) world: both ranks decode every row,
    only pipe index 0 scores it; the counts equal a one-process decode of
    the checkpointed weights."""
    _, meta = world.result("trainer_m2", 0)
    _, meta1 = world.result("trainer_m2", 1)
    assert meta["eval"] == meta1["eval"]
    _, over, _ = worker.CASES["trainer_m2"]
    cfg = apply_overrides(worker.config(over), {
        "train.checkpoint_dir": os.path.join(world.root, "ck_m2")})
    tok = CharTokenizer.english()
    inf = Inferencer(cfg, tok, device="cpu")
    counts = np.zeros(5, np.int64)
    for batch, n in worker.pipeline(cfg).eval_epoch():
        lp, lens = inf.forward(batch["features"], batch["feat_lens"])
        ids, out_lens = greedy_decode(lp, lens)
        for j, hyp in enumerate(ids_to_texts(ids, out_lens, tok)[:n]):
            ref = tok.decode(batch["labels"][j][:batch["label_lens"][j]])
            counts += (*word_errors(ref, hyp), *char_errors(ref, hyp), 1)
    werr, wtot, cerr, ctot, n = (int(c) for c in counts)
    assert meta["eval"] == {"wer": werr / max(wtot, 1),
                            "cer": cerr / max(ctot, 1), "n_utts": n}
    assert n == worker.N_UTTS


def test_checkpoint_is_dense_and_restores_in_one_process(world):
    """The pipe run's checkpoint holds the dense tree JAX's state has
    after the same two steps (``params.npz``, the stages gathered), and
    a one-process ``Inferencer`` restores it: its log-probs are the pipe
    run's eval logits' log-softmax, bit for bit (the sequential path on
    the whole batch and the schedule on its microbatches make the same
    calls row for row)."""
    _, over, _ = worker.CASES["trainer_m2"]
    ck = os.path.join(world.root, "ck_m2")
    world.wait()
    steps = sorted(int(d) for d in os.listdir(ck) if d.isdigit())
    params, stats = bridge.load_npz(os.path.join(ck, str(steps[-1]),
                                                 "params.npz"))
    state, _ = _jax_trainer("trainer_m2")
    got = _flat({"params": params, "batch_stats": stats})
    ref = _flat({"params": state.params, "batch_stats": state.batch_stats})
    assert {k: v.shape for k, v in got.items()} == \
        {k: v.shape for k, v in ref.items()}
    for k, v in ref.items():
        _close(got[k], v, STEP_TOL, k)
    cfg = apply_overrides(worker.config(over), {"train.checkpoint_dir": ck})
    inf = Inferencer(cfg, CharTokenizer.english(), device="cpu")
    assert inf.model.rnn_pipe.wh_fw.shape[0] == 2
    feats, lens = _inputs()
    lp, _ = inf.forward(feats, lens)
    arrays, _ = world.result("trainer_m2", 0)
    want = torch.log_softmax(torch.from_numpy(arrays["eval_logits"]), -1)
    np.testing.assert_array_equal(lp.numpy(), want.numpy())


def test_resume_into_a_pipe_run_is_bit_identical(world):
    """2 epochs of 2 steps on (1, 2, 1) with checkpoints: stopped at step
    3 (mid-epoch 1; every rank gathers, the primary writes), resumed from
    it (each rank taking its stage), the run ends with the uninterrupted
    run's bits."""
    for rank in (0, 1):
        _, meta = world.result("resume", rank)
        assert meta["cut"] == {"step": 3, "preempted": True}
        assert meta["restored_at"] == [3, 1]
        assert meta["full"]["step"] == meta["resumed"]["step"] == 4
        full, _ = world.result("resume_full", rank)
        resumed, _ = world.result("resume_resumed", rank)
        assert sorted(full) == sorted(resumed)
        for k in full:
            np.testing.assert_array_equal(resumed[k], full[k], err_msg=k)


# -- refusals and the mesh, in this process --------------------------------

def _jax_error(over, shape):
    """The error JAX's ``Trainer`` raises for ``over`` on a mesh of
    ``shape`` (its guards run before the model is built)."""
    jcfg = _jax_config(over)
    pipe = _SyntheticPipeline(jcfg, n_utts=8, frames=64, label_len=4)
    try:
        JaxTrainer(jcfg, pipe, JaxCharTokenizer.english(),
                   logger=JsonlLogger(echo=False),
                   mesh=jax_make_mesh(shape))
    except ValueError as e:
        return str(e)
    return None


@pytest.mark.parametrize("over,jax_shape,mesh,names", [
    ({}, (1, 1), None, "pipe"),
    ({}, (1, 1, 1), (1, 1, 1), "pipe"),
    ({"model.pipeline_microbatches": "3"}, (1, 2, 1), "pipe2",
     "microbatches"),
    ({"train.accum_steps": "4", "model.pipeline_microbatches": "4"},
     (1, 2, 1), "pipe2", "microbatches"),
], ids=["no_pipe_axis", "pipe_extent", "microbatches", "accum"])
def test_refusals_are_jax(over, jax_shape, mesh, names):
    """A pipelined tree without the pipe axis, a pipe extent other than
    the stages, and a batch that does not divide by accum x microbatches
    x data: ``Trainer`` raises JAX's ``ValueError``, word for word."""
    cfg = worker.config(over)
    if mesh == "pipe2":
        mesh = Mesh(1, 1, pipe=2)
    elif mesh is not None:
        mesh = make_mesh(mesh)
    with pytest.raises(ValueError) as e:
        Trainer(cfg, worker.pipeline(cfg), CharTokenizer.english(),
                device="cpu", mesh=mesh)
    assert names in str(e.value)
    assert str(e.value) == _jax_error(over, jax_shape)


def test_sequence_parallel_excludes_pipelining():
    cfg = worker.config({"train.sequence_parallel": "true"})
    with pytest.raises(ValueError, match="pipeline_stages>1"):
        check_supported(cfg)


def test_mesh_coordinates_of_2_2_2_are_jax():
    """Rank r of a (2, 2, 2) mesh sits where device r sits in JAX's mesh
    over ``jax.devices()``; each axis's groups are the ranks along that
    axis there, the hops the adjacent pairs of each pipe line, and each
    rank's rows JAX's batch sharding's, without spawning 8 ranks."""
    jm = jax_make_mesh((2, 2, 2))
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    groups = port_mesh.axis_groups(2, 2, 2)
    index = jax_mesh.batch_sharding(jm).devices_indices_map((32,))
    for d, p, m in np.ndindex(2, 2, 2):
        r = int(ids[d, p, m])
        mesh = Mesh(2, 2, rank=r, pipe=2)
        assert (mesh.data_index, mesh.pipe_index, mesh.model_index) == (
            d, p, m)
        assert mesh.shape == dict(jm.shape) and mesh.size == 8
        assert [int(ids[i, p, m]) for i in range(2)] in groups["data"]
        assert [int(ids[d, i, m]) for i in range(2)] in groups["pipe"]
        assert [int(ids[d, p, i]) for i in range(2)] in groups["model"]
        assert mesh.stage_rank(1 - p) == int(ids[d, 1 - p, m])
        s = index[jm.devices[d, p, m]][0]
        assert port_mesh.process_local_rows(mesh, 32) == (s.start or 0,
                                                          s.stop or 32)
    assert groups["hop"] == [line for line in groups["pipe"]]
    assert all(len(g) == 4 for g in groups.values())
