"""Data-parallel training (item 10) on two gloo ranks against the JAX
package's ``make_train_step`` on a (2, 1) or (1, 2) mesh of its 8
virtual CPU devices, over the same global batches, at a tiny width (H=32,
2 GRU layers, float32, a global batch of 8).

One two-rank world and one one-rank world are spawned once for the
module (``tests/test_torch_dp_worker.py``, a ``file://`` store in a temp
directory, each child under its own 120 s timeout); the tests hold what
each case left. Tolerances, as ``test_torch_guardian.py`` holds a step:
parameters, BN buffers, the gathered optimizer state, the loss and the
gradient norm within 1e-5 for SGD and 1e-4 for AdamW (of each leaf's
largest magnitude). The two ranks agree bit for bit, and a one-rank group
gives the bits of no group.
"""

import json
import os
import subprocess
import sys
import time
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeech_tpu.config import apply_overrides as jax_apply_overrides
from deepspeech_tpu.config import get_config as jax_get_config
from deepspeech_tpu.data import CharTokenizer as JaxCharTokenizer
from deepspeech_tpu.data import DataPipeline as JaxDataPipeline
from deepspeech_tpu.models import create_model as jax_create_model
from deepspeech_tpu.parallel import make_mesh as jax_make_mesh
from deepspeech_tpu.train import TrainState
from deepspeech_tpu.train import make_lr_schedule as jax_lr_schedule
from deepspeech_tpu.train import make_optimizer as jax_make_optimizer
from deepspeech_tpu.train import make_train_step, state_shardings
from deepspeech_tpu_torch.bridge import flax_path, init_params
from deepspeech_tpu_torch.data import Utterance, save_manifest
from deepspeech_tpu_torch.train import Trainer

import test_torch_dp_worker as worker

# One CPU thread for torch: parallel test workers share the machine's
# cores, and a thread pool in each worker oversubscribes them.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD_TIMEOUT_S = 120
# The children's torch holds to one thread, as this process does.
CHILD_ENV = {**os.environ, "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1",
             "PYTHONPATH": ROOT}
TOL = {"sgd": 1e-5, "adamw": 1e-4}


def _write_wav(path, audio):
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((np.clip(audio, -1, 1) * 32767).astype(np.int16)
                      .tobytes())


def _write_corpus(root):
    rng = np.random.default_rng(7)
    utts = []
    for i in range(12):
        dur = round(float(rng.uniform(0.4, 1.9)), 3)
        t = np.arange(int(dur * 16000)) / 16000.0
        _write_wav(os.path.join(root, f"u{i}.wav"),
                   0.3 * np.sin(2 * np.pi * rng.uniform(100, 2000) * t)
                   + 0.05 * rng.normal(size=t.shape))
        text = "".join(rng.choice(list("abcdefgh "), size=6)).strip() or "a"
        utts.append(Utterance(os.path.join(root, f"u{i}.wav"), text, dur))
    save_manifest(os.path.join(root, "train.jsonl"), utts)


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
    root = str(tmp_path_factory.mktemp("dp"))
    _write_corpus(root)
    # A dense one-card checkpoint (AdamW, one step) for restore_case.
    cfg = worker.config({"train.checkpoint_dir":
                         os.path.join(root, "ck_dense")}, "adamw")
    pipe = worker.pipeline(cfg)
    tr = worker.trainer(cfg, pipe)
    tr.train_step(pipe.batches[0])
    tr.save(0)
    tr.ckpt.wait()
    procs = []
    for ws, ranks in ((2, (0, 1)), (1, (0,))):
        url = "file://" + os.path.join(root, f"store{ws}")
        for r in ranks:
            procs.append((f"world {ws} rank {r}", subprocess.Popen(
                [sys.executable, os.path.join(ROOT, "tests",
                                              "test_torch_dp_worker.py"),
                 str(r), str(ws), url, root],
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

def _jax_config(over, opt):
    return jax_apply_overrides(jax_get_config("ds2_small"),
                               dict(worker.SMALL, **worker.OPTS[opt], **over))


def _jax_run(over, opt):
    """The JAX step on the case's mesh over the worker's batches, from
    the same bridged init: (state, metrics)."""
    jcfg = _jax_config(over, opt)
    tcfg = worker.config(over, opt)
    params, stats = init_params(tcfg, torch.Generator().manual_seed(0))
    batches = worker.pipeline(tcfg).batches
    mesh = jax_make_mesh(tuple(jcfg.train.mesh_shape))
    model = jax_create_model(jcfg.model, mesh=mesh)
    opt_ = jax_make_optimizer(jcfg, len(batches))
    jparams = jax.tree.map(jnp.asarray, params)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=jparams,
                       batch_stats=jax.tree.map(jnp.asarray, stats),
                       opt_state=opt_.init(jparams))
    sh = state_shardings(mesh, state, zero_opt=jcfg.train.zero_opt_sharding)
    step = make_train_step(jcfg, model, opt_, mesh, sh,
                           lr_schedule=jax_lr_schedule(jcfg, len(batches)))
    state = jax.device_put(state, sh)
    metrics = []
    for b in batches:
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _find(state, field):
    """The params-shaped subtree ``field`` (trace, mu, nu) of an optax
    state."""
    if hasattr(state, field):
        return getattr(state, field)
    if hasattr(state, "inner_state"):
        return _find(state.inner_state, field)
    if isinstance(state, (tuple, list)):
        for s in state:
            got = _find(s, field)
            if got is not None:
                return got
    return None


def _close(got, ref, tol, what):
    scale = max(float(np.abs(ref).max()), 1.0)
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol * scale,
                               err_msg=what)


def _port_opt(arrays, key):
    """The port's dense optimizer state ``key`` by flax path, conv
    kernels turned to HWIO."""
    out = {}
    for name, v in arrays.items():
        if not (name.startswith("opt/") and name.endswith("/" + key)):
            continue
        tname = name[4:-len(key) - 1]
        path, _, dim = flax_path(tname, v.shape)
        out[path] = v.transpose(2, 3, 1, 0) if dim == 2 else v
    return out


def _check_case(world, case, field_map):
    over, opt = worker.STEP_CASES[case]
    tol = TOL[opt]
    state, ref_metrics = _jax_run(over, opt)
    got, meta = world.result(case, 0)
    other, meta1 = world.result(case, 1)
    # The two ranks, bit for bit.
    assert sorted(got) == sorted(other)
    for k in got:
        np.testing.assert_array_equal(got[k], other[k], err_msg=k)
    assert meta["metrics"] == meta1["metrics"]
    for g, r in zip(meta["metrics"], ref_metrics):
        np.testing.assert_allclose(g["loss"], r["loss"], rtol=tol)
        np.testing.assert_allclose(g["grad_norm"], r["grad_norm"], rtol=tol)
    ref_p = _flat(state.params)
    for k, v in ref_p.items():
        _close(got[f"params/{k}"], v, tol, k)
    for k, v in _flat(state.batch_stats).items():
        _close(got[f"batch_stats/{k}"], v, 1e-5, k)
    for field, key in field_map.items():
        ref = _flat(_find(state.opt_state, field))
        mine = _port_opt(got, key)
        assert sorted(mine) == sorted(ref), field
        for k, v in ref.items():
            _close(mine[k], v, tol, f"{field} {k}")
    return got, meta


SGD = {"trace": "momentum_buffer"}
ADAM = {"mu": "exp_avg", "nu": "exp_avg_sq"}


def test_dp_sgd_matches_jax(world):
    """Two ranks of 4 rows each against JAX on a (2, 1) mesh: global
    masked BN statistics, one flat gradient all-reduce, the loss reported
    as the global mean."""
    _check_case(world, "dp_sgd", SGD)


def test_evaluate_sums_each_ranks_rows(world):
    """``evaluate`` at world size 2: each rank decodes its 4 rows of each
    8-row batch, the counts all-reduced; one process decoding all the
    rows with the same weights counts the same."""
    got, meta = world.result("dp_sgd", 0)
    _, meta1 = world.result("dp_sgd", 1)
    assert meta["eval"] == meta1["eval"] and meta["eval"]["n_utts"] == 16
    over, opt = worker.STEP_CASES["dp_sgd"]
    cfg = worker.config({}, opt)
    params = {k[len("params/"):]: v for k, v in got.items()
              if k.startswith("params/")}
    stats = {k[len("batch_stats/"):]: v for k, v in got.items()
             if k.startswith("batch_stats/")}
    from deepspeech_tpu_torch.bridge import _nest

    tr = Trainer(cfg, worker.pipeline(cfg), worker.CharTokenizer.english(),
                 logger=worker.Quiet(), device="cpu",
                 params=_nest({k.replace("/", "."): v
                               for k, v in params.items()}),
                 batch_stats=_nest({k.replace("/", "."): v
                                    for k, v in stats.items()}))
    assert tr.evaluate() == meta["eval"]


def test_strided_accumulation_matches_jax(world):
    """accum_steps=2 over data=2: each rank's contiguous 4 rows split
    locally as rows[k::2], the global microbatch k's share."""
    _check_case(world, "accum", SGD)


def test_zero_adamw_matches_jax_and_the_dense_run(world):
    """ZeRO-1 with AdamW: within 1e-4 of JAX with zero_opt_sharding,
    and bit for bit the dense two-rank run (the optimizers are
    elementwise); the gathered moments are the dense layout."""
    got, _ = _check_case(world, "zero_adamw", ADAM)
    dense, _ = world.result("dense_adamw", 0)
    assert sorted(got) == sorted(dense)
    for k in got:
        np.testing.assert_array_equal(got[k], dense[k], err_msg=k)


def test_head_over_the_model_axis_matches_jax(world):
    """mesh (1, 2) with V=32: each rank holds 16 columns of the head and
    gathers the logits; the gathered parameters and momentum are JAX's
    with the head sharded over its model axis."""
    _, meta = _check_case(world, "tp32", SGD)
    assert meta["head_sharded"] and not meta["warnings"]


def test_29_way_head_replicates_with_the_warning(world):
    """V=29 does not divide over model=2: the head is replicated with
    JAX's warning, and the step still matches JAX on (1, 2)."""
    _, meta = _check_case(world, "tp29", SGD)
    assert not meta["head_sharded"]
    assert any("head/bias" in w and "replicating" in w
               for w in meta["warnings"]), meta["warnings"]


def test_one_poisoned_rank_gates_both(world):
    """Rank 1's rows of the second batch are NaN: both ranks see a
    non-finite loss and gradient norm (all-reduced), skip the step with
    the state bit for bit as it was, and apply the third."""
    for rank in (0, 1):
        _, meta = world.result("guard", rank)
        assert meta["applied"] == [True, False, True], meta
        assert meta["skip_kept_state"] is True and meta["step"] == 2
    a, _ = world.result("guard", 0)
    b, _ = world.result("guard", 1)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_mid_epoch_resume_at_world_size_2_is_bit_identical(world):
    """ZeRO AdamW, 2 epochs of 4 steps, a checkpoint every 3: stopped at
    step 5 (mid-epoch 1; the primary writes, the other waits), resumed
    from it, the run ends with the uninterrupted run's bits."""
    for rank in (0, 1):
        _, meta = world.result("resume", rank)
        assert meta["cut"] == {"step": 5, "preempted": True}
        assert meta["restored_at"] == [5, 1]
        assert meta["full"]["step"] == meta["resumed"]["step"] == 8
        full, _ = world.result("resume_full", rank)
        resumed, _ = world.result("resume_resumed", rank)
        for k in full:
            np.testing.assert_array_equal(resumed[k], full[k], err_msg=k)


def test_zero_checkpoint_restores_into_a_dense_run(world):
    """The ZeRO run's optimizer.pt has the dense layout: a one-process
    dense Trainer restores it, its state equal to the gathered one."""
    full, _ = world.result("resume_full", 0)
    over, _ = worker.STEP_CASES["dense_adamw"]
    cfg = worker.config({"train.checkpoint_dir": os.path.join(
        world.root, "ck_full"), "train.epochs": "2"}, "adamw")
    tr = worker.trainer(cfg, worker.pipeline(cfg, 32))
    tr.maybe_restore()
    assert tr.step == 8 and not tr._zero
    names = [n for n, _ in tr.model.named_parameters()]
    state = tr.optimizer.state_dict()["state"]
    assert sorted(state) == list(range(len(names)))
    for i, st in state.items():
        for k, v in st.items():
            np.testing.assert_array_equal(v.numpy(),
                                          full[f"opt/{names[i]}/{k}"])


def test_dense_checkpoint_restores_into_zero(world):
    """A dense one-card checkpoint restored into ZeRO over two ranks: each
    rank keeps its rows of every ZeRO leaf's moments, and gathered they
    are the file's."""
    dense = torch.load(os.path.join(world.root, "ck_dense", "1",
                                    "optimizer.pt"), weights_only=True)
    names = [n for n, _ in worker.trainer(
        worker.config({}, "adamw"),
        worker.pipeline(worker.config({}, "adamw"))).model.named_parameters()]
    for rank in (0, 1):
        got, meta = world.result("restore", rank)
        assert meta["step"] == 1 and meta["zero"]
        for i, st in dense["state"].items():
            name = names[i]
            for k, v in st.items():
                np.testing.assert_array_equal(got[f"opt/{name}/{k}"],
                                              v.numpy())
                if name in meta["zero"] and v.dim():
                    dim, lo, n = meta["zero"][name]
                    np.testing.assert_array_equal(
                        got[f"rows/{name}/{k}"], v.narrow(dim, lo, n).numpy())


def test_each_rank_builds_its_rows_of_the_jax_batch(world):
    """Each rank's manifest batch holds the JAX pipeline's batch[lo:hi]
    in its rows (the process-major split) and zeros elsewhere, for a
    training batch and an eval batch."""
    jcfg = jax_apply_overrides(jax_get_config("ds2_small"), {
        "data.batch_size": "4", "data.bucket_frames": "100,200",
        "data.max_duration_s": "2.0"})
    jpipe = JaxDataPipeline(jcfg, JaxCharTokenizer.english(),
                            os.path.join(world.root, "train.jsonl"))
    plan = next(iter(jpipe.sampler.epoch(0)))
    ref = {"train": jpipe._materialize(plan, epoch=0),
           "eval": next(iter(jpipe.eval_epoch()))[0]}
    for rank in (0, 1):
        got, _ = world.result("rows", rank)
        lo, hi = 2 * rank, 2 * rank + 2
        for kind, batch in ref.items():
            for k, v in batch.items():
                mine = got[f"{kind}/{k}"]
                np.testing.assert_array_equal(mine[lo:hi], v[lo:hi],
                                              err_msg=f"{kind} {k}")
                rest = np.delete(mine, np.s_[lo:hi], axis=0)
                assert not rest.any(), (kind, k)


def test_ranks_with_different_inits_refuse(world):
    """Every rank seeds its init alike, with no broadcast; a rank seeded
    otherwise makes every rank's Trainer raise at init (one all-gather
    of a checksum)."""
    for rank in (0, 1):
        _, meta = world.result("mismatch", rank)
        assert "initial parameters differ" in meta["error"], meta


@pytest.mark.parametrize("case", sorted(worker.W1_CASES))
def test_world_size_1_is_bit_identical_to_no_group(world, case):
    """The same steps under a one-rank gloo group (mesh (1, 1)) and in
    this process with no group: the same bits. Under the group the
    collectives run over the one rank (the BN statistics' and the
    gradients' all-reduces; ZeRO's rows and all-gather), which is
    exact; with no group none runs."""
    over, opt = worker.W1_CASES[case]
    cfg = worker.config(over, opt)
    pipe = worker.pipeline(cfg)
    tr = worker.trainer(cfg, pipe)
    metrics = [{k: float(v) for k, v in tr.train_step(b).items()}
               for b in pipe.batches]
    ref = worker.state_arrays(tr)
    assert tr.model.bn_out.group is None and not tr._zero
    got, meta = world.result(case, 0)
    assert meta["bn_grouped"]
    assert (meta["zero_leaves"] > 0) == (
        over.get("train.zero_opt_sharding") == "true")
    assert meta["metrics"] == metrics
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
