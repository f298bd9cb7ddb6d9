"""The port's guarded, preemption-safe training (``resilience/guardian.py``,
``resilience/preempt.py``, ``utils/logging.py`` and ``Trainer``'s guarded
step), held to the JAX package's.

The guardian, watchdog, preemption and checkpoint-fault cases of
tests/test_resilience.py and the guarded-step, profile, throughput and
TensorBoard cases of tests/test_train.py run on the port's classes.
Against the JAX package: the guardian's decisions and ``lr_scale``
sequence equal the JAX guardian's exactly on one scalar stream, and the
parameters after a guarded run with a poisoned step are within 1e-5 of
``make_train_step(guardian=True)``'s. Within the port, bit for bit: a
skipped step leaves parameters, BN statistics and optimizer state as they
were (SGD and AdamW, a first step too); a guarded run with a poisoned
batch ends where an unguarded run without that batch ends; a rollback
ends where an unguarded run without the rolled-back batches ends; and a
preempted run, resumed, ends where the uninterrupted one does. Models
are tiny (H=24, 2 GRU layers, 4 conv channels) and f32, on the CPU.
"""

import dataclasses
import json
import math
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeech_tpu.obs.metrics import MetricsRegistry as JaxRegistry
from deepspeech_tpu.resilience.guardian import \
    GuardianConfig as JaxGuardianConfig
from deepspeech_tpu.resilience.guardian import \
    TrainingGuardian as JaxTrainingGuardian
from deepspeech_tpu.resilience.postmortem import \
    PostmortemWriter as JaxPostmortemWriter
from deepspeech_tpu_torch.checkpoint import CheckpointManager
from deepspeech_tpu_torch.config import apply_overrides
from deepspeech_tpu_torch.data import CharTokenizer, SyntheticPipeline
from deepspeech_tpu_torch.obs.metrics import MetricsRegistry
from deepspeech_tpu_torch.resilience import (FaultPlan, FaultSpec,
                                             GuardianConfig, GuardianHalt,
                                             PostmortemWriter,
                                             PreemptionGuard, StallWatchdog,
                                             TrainingGuardian, faults)
from deepspeech_tpu_torch.train import Trainer
from test_torch_train import OPTS, _assert_trees_close, _configs, _setup

# One CPU thread for torch: parallel test workers share the machine's
# cores, and a thread pool in each worker oversubscribes them.
torch.set_num_threads(1)

QUIET = '{"watchdog": false}'


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


class Quiet:
    """A logger that keeps its events."""

    def __init__(self, on_step=None):
        self.events = []
        self.on_step = on_step

    def log(self, event, **fields):
        self.events.append((event, fields))
        if event == "train_step" and self.on_step is not None:
            self.on_step(fields["step"])


@pytest.fixture(autouse=True)
def _no_env_guardian(monkeypatch):
    monkeypatch.delenv("DS2_GUARDIAN", raising=False)
    yield
    faults.clear()


# -- checkpoint fault points and the ring ---------------------------------------

def _state(v):
    return {"params": {"w": np.full((2,), float(v), np.float32)},
            "batch_stats": {}, "epoch": 0}


def test_checkpoint_restore_raises_when_no_step_is_intact(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"), keep=3)
    faults.install(FaultPlan([FaultSpec("checkpoint.save", "partial_write")]))
    try:
        mgr.save(1, _state(0))
        mgr.wait()
    finally:
        faults.clear()
    with pytest.raises(Exception):
        mgr.restore()
    mgr.close()


def test_restore_walks_past_torn_and_guardian_rejected_steps(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"), keep=5)
    mgr.save(1, _state(1))
    mgr.save(2, _state(2))
    mgr.wait()
    faults.install(FaultPlan([FaultSpec("checkpoint.save", "partial_write",
                                        count=1)]))
    try:
        mgr.save(3, _state(3))
        mgr.wait()
    finally:
        faults.clear()
    mgr.mark_rejected(2)
    got = mgr.restore()                   # 3 is torn, 2 rejected -> 1
    assert got["step"] == 1 and float(got["params"]["w"][0]) == 1.0
    mgr.close()
    mgr2 = CheckpointManager(str(tmp_path / "ck"), keep=5)
    assert mgr2.rejected_steps() == (2,)
    assert mgr2.restore()["step"] == 1
    assert float(mgr2.restore(step=2)["params"]["w"][0]) == 2.0
    mgr2.close()
    # An injected restore error walks back like a damaged step: the
    # second restore's first candidate (step 3) fails by injection.
    mgr3 = CheckpointManager(str(tmp_path / "ck3"), keep=5)
    for s in (1, 2, 3):
        mgr3.save(s, _state(s))
    mgr3.wait()
    faults.install(FaultPlan([FaultSpec("checkpoint.restore", "error",
                                        skip=1, count=1)]))
    try:
        assert mgr3.restore()["step"] == 3
        assert mgr3.restore()["step"] == 2
        assert mgr3.restore()["step"] == 3
    finally:
        faults.clear()
    mgr3.close()


def test_checkpoint_last_good_ring_is_bounded_and_newest_first(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"), keep=2, last_good_keep=2)
    assert mgr.restore_last_good() is None
    for s in (4, 8, 12):
        mgr.save_last_good(s, {"w": torch.full((2,), float(s))},
                           meta={"applied_len": s})
    assert mgr.last_good_steps() == (8, 12)
    step, state, meta = mgr.restore_last_good()
    assert step == 12 and meta == {"applied_len": 12}
    assert torch.equal(state["w"], torch.full((2,), 12.0))
    mgr.close()


def test_trainer_sizes_the_ring_from_the_guardian(tmp_path, monkeypatch):
    monkeypatch.setenv("DS2_GUARDIAN", '{"ring_size": 5, "watchdog": false}')
    _, cfg = _configs("ds2_small", {"train.checkpoint_dir":
                                    str(tmp_path / "ck")})
    tr = Trainer(cfg, SyntheticPipeline(cfg, 4), CharTokenizer.english(),
                 device="cpu")
    assert tr.guardian is not None and tr.guardian.cfg.ring_size == 5
    assert tr.ckpt._last_good.maxlen == 5


# -- the preemption guard -------------------------------------------------------

def test_preemption_guard_latches_real_sigterm_and_restores_handler():
    prev = signal.getsignal(signal.SIGTERM)
    with PreemptionGuard() as g:
        assert not g.requested()
        os.kill(os.getpid(), signal.SIGTERM)
        assert g.requested() and g.signum == signal.SIGTERM
        g.reset()
        assert not g.requested() and g.signum is None
        g.trigger()
        assert g.requested()
    assert signal.getsignal(signal.SIGTERM) is prev


# -- the guardian ---------------------------------------------------------------

def _guardian(cfg=None, **kw):
    reg = MetricsRegistry()
    pm = PostmortemWriter(registry=reg)
    g = TrainingGuardian(cfg if cfg is not None else GuardianConfig(),
                         registry=reg, postmortem=pm, **kw)
    return g, reg, pm


def _metrics(loss=1.0, grad=2.0, upd=0.1):
    return {"loss": loss, "grad_norm": grad, "update_norm": upd}


def test_guardian_classifies_each_nonfinite_scalar_as_hard():
    g, _, _ = _guardian()
    assert g.classify(1.0, 2.0, 0.1) == ("ok", "")
    assert g.classify(float("nan"), 2.0, 0.1) == ("hard", "nonfinite_loss")
    assert g.classify(1.0, float("inf"), 0.1) == \
        ("hard", "nonfinite_grad_norm")
    assert g.classify(1.0, 2.0, float("nan")) == \
        ("hard", "nonfinite_update_norm")


def test_guardian_skip_ladder_escalates_to_rollback_decision():
    g, reg, pm = _guardian(GuardianConfig(max_consecutive_skips=2))
    assert g.observe_step(0, 0, _metrics()).action == "ok"
    assert g.applied == [0]
    nan = _metrics(loss=float("nan"))
    assert g.observe_step(1, 1, nan).action == "skip"
    assert g.observe_step(1, 2, nan).action == "skip"
    d = g.observe_step(1, 3, nan)
    assert d.action == "rollback" and d.classify == "hard"
    assert d.trigger == "nonfinite_loss"
    assert g.applied == [0]
    assert reg.counter("guardian_skipped_batches") == 3
    recs = pm.recent("anomaly")
    assert len(recs) == 3
    assert all(r["trigger"] == "nonfinite_loss" for r in recs)
    g2, _, _ = _guardian(GuardianConfig(max_consecutive_skips=2))
    for i in range(6):
        assert g2.observe_step(i, 2 * i, nan).action == "skip"
        assert g2.observe_step(i, 2 * i + 1, _metrics()).action == "ok"


def test_guardian_total_skip_budget_forces_rollback():
    g, _, _ = _guardian(GuardianConfig(max_skips=2,
                                       max_consecutive_skips=99))
    nan = _metrics(loss=float("nan"))
    assert g.observe_step(0, 0, nan).action == "skip"
    assert g.observe_step(0, 1, nan).action == "skip"
    assert g.observe_step(0, 2, nan).action == "rollback"


def test_guardian_soft_spike_backs_off_lr_and_recovers():
    cfg = GuardianConfig(stats_warmup_steps=5, soft_grad_factor=10.0,
                         backoff_factor=0.5, min_lr_scale=0.25,
                         recovery_steps=3)
    g, reg, pm = _guardian(cfg)
    for i in range(4):
        assert g.observe_step(i, i, _metrics(grad=1.0)).action == "ok"
    assert g.observe_step(4, 4, _metrics(grad=500.0)).action == "ok"
    g.observe_step(5, 5, _metrics(grad=1.0))
    d = g.observe_step(6, 6, _metrics(grad=50.0))
    assert d.action == "backoff" and d.classify == "soft"
    assert d.trigger == "grad_norm_spike"
    assert g.lr_scale == 0.5
    assert len(g.applied) == 7
    g.observe_step(7, 7, _metrics(grad=50.0))
    g.observe_step(8, 8, _metrics(grad=50.0))
    assert g.lr_scale == 0.25
    assert reg.counter("guardian_soft_anomalies") == 3
    assert len(pm.recent("anomaly")) == 3
    for i in range(9, 12):
        assert g.observe_step(i, i, _metrics(grad=1.0)).action == "ok"
    assert g.lr_scale == 0.5
    for i in range(12, 15):
        g.observe_step(i, i, _metrics(grad=1.0))
    assert g.lr_scale == 1.0


def test_guardian_rollback_restores_ring_and_rejects_newer_disk(tmp_path):
    reg = MetricsRegistry()
    pm = PostmortemWriter(registry=reg)
    mgr = CheckpointManager(str(tmp_path / "ck"), keep=3, last_good_keep=2)
    g = TrainingGuardian(GuardianConfig(max_rollbacks=1), ckpt=mgr,
                         registry=reg, postmortem=pm)
    g.applied.extend([0, 1, 2])
    assert g.snapshot(3, {"w": torch.full((4,), 7.0)})
    assert mgr.last_good_steps() == (3,)
    g.applied.extend([3, 4])
    mgr.save(5, _state(9))
    mgr.wait()
    step, host = g.rollback("nonfinite_loss")
    assert step == 3
    assert torch.equal(host["w"], torch.full((4,), 7.0))
    assert g.applied == [0, 1, 2]
    assert mgr.rejected_steps() == (5,)
    assert reg.counter("guardian_rollbacks") == 1
    (rb,) = pm.recent("rollback")
    assert rb["to_step"] == 3 and rb["dropped_applied_steps"] == 2
    with pytest.raises(GuardianHalt, match="budget"):
        g.rollback("again")
    mgr.close()
    g2 = TrainingGuardian(GuardianConfig(), ckpt=None, registry=reg,
                          postmortem=pm)
    with pytest.raises(GuardianHalt, match="CheckpointManager"):
        g2.rollback("x")
    mgr3 = CheckpointManager(str(tmp_path / "ck2"))
    g3 = TrainingGuardian(GuardianConfig(), ckpt=mgr3, registry=reg,
                          postmortem=pm)
    with pytest.raises(GuardianHalt, match="ring"):
        g3.rollback("x")
    mgr3.close()


def test_guardian_snapshot_cadence_counts_applied_steps(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"), last_good_keep=3)
    g = TrainingGuardian(GuardianConfig(snapshot_every=2), ckpt=mgr,
                         registry=MetricsRegistry(),
                         postmortem=PostmortemWriter(
                             registry=MetricsRegistry()))
    for i in range(5):
        g.observe_step(i, i, _metrics())
        g.maybe_snapshot(i + 1, {"w": torch.zeros(2)})
    assert mgr.last_good_steps() == (2, 4)
    mgr.close()


def test_guardian_config_from_env(tmp_path, monkeypatch):
    assert GuardianConfig.from_env() is None
    for off in ("0", "false", "off", "no", ""):
        monkeypatch.setenv("DS2_GUARDIAN", off)
        assert GuardianConfig.from_env() is None
    monkeypatch.setenv("DS2_GUARDIAN", "1")
    assert GuardianConfig.from_env() == GuardianConfig()
    monkeypatch.setenv("DS2_GUARDIAN", '{"ring_size": 5, "watchdog": false}')
    cfg = GuardianConfig.from_env()
    assert cfg.ring_size == 5 and cfg.watchdog is False
    p = tmp_path / "g.json"
    p.write_text('{"max_skips": 3}')
    monkeypatch.setenv("DS2_GUARDIAN", str(p))
    assert GuardianConfig.from_env().max_skips == 3
    # The port reads the same fields as the JAX guardian, defaults too.
    assert dataclasses.asdict(GuardianConfig()) == \
        dataclasses.asdict(JaxGuardianConfig())


def test_guardian_decisions_and_lr_scale_equal_jax():
    """One seeded stream of (loss, grad norm, update norm) scalars, with
    non-finite steps and gradient spikes, through both guardians: every
    decision, every ``lr_scale`` and the applied list are equal."""
    rng = np.random.default_rng(11)
    cfg = dict(stats_warmup_steps=6, soft_grad_factor=4.0,
               backoff_factor=0.5, min_lr_scale=0.125, recovery_steps=4,
               max_consecutive_skips=2, max_skips=8)
    port, _, _ = _guardian(GuardianConfig(**cfg))
    jreg = JaxRegistry()
    ref = JaxTrainingGuardian(JaxGuardianConfig(**cfg), registry=jreg,
                              postmortem=JaxPostmortemWriter(registry=jreg))
    seen = []
    for i in range(300):
        u = rng.uniform()
        grad = float(rng.lognormal(0.0, 0.3))
        m = _metrics(loss=float(rng.uniform(1, 5)), grad=grad, upd=0.01)
        if u < 0.08:
            m["loss" if u < 0.04 else "update_norm"] = float("nan")
        elif u < 0.2:
            m["grad_norm"] = grad * float(rng.uniform(3, 30))
        a = port.observe_step(i, i, m)
        b = ref.observe_step(i, i, m)
        assert (a.action, a.classify, a.trigger) == \
            (b.action, b.classify, b.trigger), i
        assert port.lr_scale == ref.lr_scale, i
        seen.append(a.action)
    assert port.applied == ref.applied
    assert port.report() == ref.report()
    assert {"ok", "backoff", "skip", "rollback"} <= set(seen)


# -- the stall watchdog ---------------------------------------------------------

def test_stall_watchdog_timeout_tracks_p95_and_fires_once():
    reg = MetricsRegistry()
    pm = PostmortemWriter(registry=reg)
    clock = Clock()
    guard = PreemptionGuard()
    w = StallWatchdog(k=10.0, min_timeout_s=5.0, registry=reg,
                      postmortem=pm, preempt=guard, clock=clock)
    assert w.timeout_s() == 5.0
    for _ in range(20):
        reg.observe("train.step_s", 1.0)
    assert w.timeout_s() == 10.0
    assert not w.check()
    w.heartbeat()
    clock.t = 9.0
    assert not w.check()
    clock.t = 11.0
    assert w.check()
    assert guard.requested()
    assert reg.counter("stall_watchdog_fires") == 1
    assert not w.check()
    (rec,) = pm.recent("stall")
    assert rec["trigger"] == "no_heartbeat"
    assert rec["stacks"]
    assert rec["timeout_s"] == 10.0
    w.heartbeat()
    clock.t = 30.0
    assert w.check()
    assert reg.counter("stall_watchdog_fires") == 2


def test_stall_watchdog_thread_lifecycle():
    w = StallWatchdog(poll_s=0.01, min_timeout_s=1e9,
                      registry=MetricsRegistry(),
                      postmortem=PostmortemWriter(registry=MetricsRegistry()))
    with w as started:
        assert started is w
        assert w._thread is not None and w._thread.is_alive()
    assert w._thread is None


# -- utils/logging ----------------------------------------------------------------

def test_throughput_window_excludes_compile_time(monkeypatch):
    import deepspeech_tpu_torch.utils.logging as L

    times = iter([0.0, 10.0, 11.0, 12.0, 13.0, 13.0])
    monkeypatch.setattr(L.time, "perf_counter", lambda: next(times))
    thr = L.Throughput(n_chips=1, window=3)
    for _ in range(4):
        thr.update(8)
    assert abs(thr.rate_per_chip() - 8.0) < 1e-6


def test_jsonl_logger_writes_lines(tmp_path, capsys):
    from deepspeech_tpu_torch.utils.logging import JsonlLogger

    log = JsonlLogger(str(tmp_path / "l.jsonl"))
    log.log("x", n=1)
    log.close()
    rec = json.loads((tmp_path / "l.jsonl").read_text())
    assert rec["event"] == "x" and rec["n"] == 1 and "time" in rec
    assert json.loads(capsys.readouterr().out) == rec


# -- the guarded step -------------------------------------------------------------

def _trainer(opt="sgd", guardian=True, over=None, **kw):
    jcfg, tcfg, params, stats, batch = _setup("ds2_small", opt)
    if guardian:
        tcfg = apply_overrides(tcfg, {"train.guardian": "true"})
    if over:
        tcfg = apply_overrides(tcfg, over)
    tr = Trainer(tcfg, SyntheticPipeline(tcfg, 4), CharTokenizer.english(),
                 device="cpu", params=params, batch_stats=stats, **kw)
    return jcfg, tr, batch


def _poison(batch):
    return dict(batch, features=batch["features"] * np.float32(np.nan))


def _opt_tensors(tr):
    return [(i, k, v.clone()) for i, st in enumerate(
        tr.optimizer.state_dict()["state"].values())
        for k, v in sorted(st.items()) if torch.is_tensor(v)]


def _same_state(tr, model, opt):
    assert all(torch.equal(model[k], v)
               for k, v in tr.model.state_dict().items())
    got = _opt_tensors(tr)
    assert [(i, k) for i, k, _ in got] == [(i, k) for i, k, _ in opt]
    assert all(torch.equal(a, b) for (_, _, a), (_, _, b) in zip(got, opt))


def _step(tr, batch, lr_scale=1.0):
    m = tr.guarded_step(batch, lr_scale)
    tr.commit_step(bool(m["applied"]))
    return m


def _syncs(monkeypatch, fn):
    """How many times ``fn`` reads a tensor's value on the host."""
    n = [0]
    with monkeypatch.context() as mp:
        for name in ("item", "tolist", "__bool__", "__float__",
                     "__int__"):
            real = getattr(torch.Tensor, name)

            def counted(self, *a, _real=real, **k):
                n[0] += 1
                return _real(self, *a, **k)

            mp.setattr(torch.Tensor, name, counted)
        out = fn()
    return n[0], out


@pytest.mark.parametrize("opt", ["sgd", "adamw"])
def test_skipped_step_is_a_bitexact_noop(opt, monkeypatch):
    """A poisoned batch after a good step: parameters, BN statistics,
    every optimizer state tensor (momentum; AdamW's moments and step)
    and the step counter stay bit for bit. The gate adds no host read
    to the step: the guarded step reads a tensor's value on the host as
    often as the unguarded one does (the CPU's plain versions read some
    of their own)."""
    _, tr, batch = _trainer(opt)
    m = _step(tr, batch)
    assert bool(m["applied"]) and tr.step == 1
    model = {k: v.clone() for k, v in tr.model.state_dict().items()}
    opt_before = _opt_tensors(tr)
    n_guarded, m = _syncs(monkeypatch,
                          lambda: tr.train_step(_poison(batch)))
    _, plain, _ = _trainer(opt, guardian=False)
    plain.train_step(batch)
    n_plain, _ = _syncs(monkeypatch,
                        lambda: plain.train_step(_poison(batch)))
    assert n_guarded == n_plain
    assert not bool(m["applied"]) and not math.isfinite(float(m["loss"]))
    tr.commit_step(False)
    assert tr.step == 1
    _same_state(tr, model, opt_before)


@pytest.mark.parametrize("opt", ["sgd", "adamw"])
def test_skipped_first_step_leaves_no_optimizer_state(opt):
    """torch creates SGD's momentum buffer (a clone of the first
    gradient) and AdamW's moments at a parameter's first step, where
    optax starts from zeros: a skipped first step leaves none, and the
    run then equals one that never saw the poisoned batch."""
    _, tr, batch = _trainer(opt)
    model = {k: v.clone() for k, v in tr.model.state_dict().items()}
    _step(tr, _poison(batch))
    assert tr.step == 0 and len(tr.optimizer.state) == 0
    _same_state(tr, model, [])
    _step(tr, batch)
    _, ref, _ = _trainer(opt, guardian=False)
    ref.train_step(batch)
    _same_state(tr, ref.model.state_dict(), _opt_tensors(ref))


@pytest.mark.parametrize("opt,tol", [("sgd", 1e-5), ("adamw", 1e-4)])
def test_guarded_run_with_poisoned_step_matches_jax(opt, tol):
    """Three guarded steps, the second on a poisoned batch, in both
    packages (``make_train_step(guardian=True)`` at ``lr_scale`` 1): the
    same ``applied`` verdicts, BN statistics within 1e-5 and parameters
    within 1e-5 for SGD. AdamW's parameters are held to 1e-4 (of each
    leaf's scale, ``test_torch_train``'s tolerance for two AdamW steps):
    its first update is ``lr * g / |g|`` per element, so an element
    whose gradient is a rounding error in both frameworks moves by up
    to ``lr`` either way."""
    from deepspeech_tpu.parallel import make_mesh
    from deepspeech_tpu.models import create_model as jax_create_model
    from deepspeech_tpu.train import TrainState
    from deepspeech_tpu.train import make_lr_schedule as jax_lr_schedule
    from deepspeech_tpu.train import make_optimizer as jax_make_optimizer
    from deepspeech_tpu.train import make_train_step, state_shardings
    from deepspeech_tpu_torch.bridge import to_flax

    jcfg, tr, batch = _trainer(opt)
    _, _, params, stats, _ = _setup("ds2_small", opt)
    batches = [batch, _poison(batch), batch]
    got = [bool(_step(tr, b)["applied"]) for b in batches]
    mesh = make_mesh((1, 1))
    model = jax_create_model(jcfg.model, mesh=mesh)
    jopt = jax_make_optimizer(jcfg, 1)
    jparams = jax.tree.map(jnp.asarray, params)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=jparams,
                       batch_stats=jax.tree.map(jnp.asarray, stats),
                       opt_state=jopt.init(jparams))
    sh = state_shardings(mesh, state)
    step = make_train_step(jcfg, model, jopt, mesh, sh, guardian=True,
                           lr_schedule=jax_lr_schedule(jcfg, 1))
    state = jax.device_put(state, sh)
    want = []
    for b in batches:
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()},
                        {"lr_scale": np.float32(1.0)})
        want.append(bool(m["applied"]))
    assert got == want == [True, False, True]
    assert tr.step == int(state.step) == 2
    got_params, got_stats = to_flax(tr.model.state_dict())
    _assert_trees_close(got_params, state.params, rtol=tol, atol=tol)
    _assert_trees_close(got_stats, state.batch_stats, rtol=1e-5, atol=1e-5)


def test_lr_backoff_flows_into_the_optimizer_rate():
    """The backoff multiplies the scheduled rate inside the optimizer:
    the rate it records is scaled, SGD's momentum (raw gradients) is the
    same at either scale, the parameters are not, the update norm is
    reported unscaled, and at ``lr_scale`` 1 the guarded step equals the
    unguarded one bit for bit."""
    _, t1, batch = _trainer()
    m1 = _step(t1, batch, lr_scale=1.0)
    _, t2, _ = _trainer()
    m2 = _step(t2, batch, lr_scale=0.25)
    lr0 = t1.lr_schedule(0)
    assert t1.optimizer.param_groups[0]["lr"] == lr0
    assert t2.optimizer.param_groups[0]["lr"] == lr0 * 0.25
    b1 = [s["momentum_buffer"] for s in t1.optimizer.state.values()]
    b2 = [s["momentum_buffer"] for s in t2.optimizer.state.values()]
    assert len(b1) == len(b2) > 0
    assert all(torch.equal(x, y) for x, y in zip(b1, b2))
    assert any(not torch.equal(x, y) for x, y in
               zip(t1.model.parameters(), t2.model.parameters()))
    assert float(m1["update_norm"]) == pytest.approx(
        float(m2["update_norm"]), rel=1e-5)
    _, t3, _ = _trainer(guardian=False)
    t3.train_step(batch)
    _same_state(t1, t3.model.state_dict(), _opt_tensors(t3))


# -- fit with the guardian --------------------------------------------------------

class _Batches:
    """A fixed list of batches with the pipeline interface; ``scale``
    multiplies the features of chosen batch indices (a gradient
    spike)."""

    def __init__(self, batches, scale=None):
        self.batches = batches
        self.scale = scale or {}

    def epoch(self, e, start=0):
        for i, b in enumerate(self.batches):
            if i < start:
                continue
            s = self.scale.get(i)
            yield b if s is None else dict(b, features=b["features"] * s)

    def batches_per_epoch(self, e):
        return len(self.batches)

    def peek(self):
        return self.batches[0]


def _batches(n):
    _, tcfg = _configs("ds2_small", OPTS["sgd"])
    from deepspeech_tpu_torch.data.synthetic import synthetic_batch
    return [synthetic_batch(tcfg, 4, 48, 5, seed=i, frames_per_label=6)[0]
            for i in range(n)]


def _fit(batches, guardian, ckdir="", env=QUIET, monkeypatch=None,
         plan=None, scale=None, logger=None, preempt=None, epochs=1,
         restore=False):
    if guardian:
        monkeypatch.setenv("DS2_GUARDIAN", env)
    else:
        monkeypatch.delenv("DS2_GUARDIAN", raising=False)
    _, tcfg, params, stats, _ = _setup("ds2_small", "sgd")
    tcfg = apply_overrides(tcfg, {"train.checkpoint_dir": ckdir,
                                  "train.log_every": "1"})
    tr = Trainer(tcfg, _Batches(batches, scale), CharTokenizer.english(),
                 logger=logger or Quiet(), device="cpu", params=params,
                 batch_stats=stats, preempt=preempt)
    if restore:
        tr.maybe_restore()
    if plan is not None:
        faults.install(plan)
    try:
        last = tr.fit(epochs=epochs)
    finally:
        faults.clear()
    return tr, last


def test_guarded_fit_skips_a_poisoned_batch_bit_identically(monkeypatch):
    """``train.step``'s ``nan_grad`` poisons the third batch: the guarded
    run skips it and ends bit for bit where an unguarded run over the
    other batches ends; the step histogram fed the watchdog's p95."""
    from deepspeech_tpu_torch import obs

    b = _batches(5)
    before = obs.registry().hists.get("train.step_s")
    n0 = before.count if before is not None else 0
    g, last = _fit(b, True, monkeypatch=monkeypatch,
                   plan=FaultPlan([FaultSpec("train.step", "nan_grad",
                                             skip=2, count=1)]))
    ref, _ = _fit(b[:2] + b[3:], False, monkeypatch=monkeypatch)
    assert last["guardian"]["skipped_batches"] == 1
    assert g.step == ref.step == 4
    _same_state(g, ref.model.state_dict(), _opt_tensors(ref))
    assert obs.registry().hists["train.step_s"].count - n0 == 5


def test_guarded_fit_rolls_back_to_the_last_good_ring(monkeypatch, tmp_path):
    """Two poisoned batches in a row with ``max_consecutive_skips`` 1:
    the second rolls back to the ring's newest snapshot (after two
    applied steps), and the run ends where an unguarded run without the
    rolled-back and poisoned batches ends."""
    b = _batches(7)
    env = ('{"max_consecutive_skips": 1, "snapshot_every": 2, '
           '"watchdog": false}')
    logger = Quiet()
    g, last = _fit(b, True, ckdir=str(tmp_path / "ck"), env=env,
                   monkeypatch=monkeypatch, logger=logger,
                   plan=FaultPlan([FaultSpec("train.step", "nan_grad",
                                             skip=3, count=2)]))
    assert last["guardian"]["rollbacks"] == 1
    assert [f["step"] for e, f in logger.events
            if e == "guardian_rollback"] == [2]
    ref, _ = _fit(b[:2] + b[5:], False, monkeypatch=monkeypatch)
    assert g.step == ref.step == 4
    _same_state(g, ref.model.state_dict(), _opt_tensors(ref))


def test_guarded_fit_soft_spike_backs_off_and_recovers(monkeypatch):
    """A silent batch (all-zero features: the masked BN divides by its
    epsilon) spikes the gradient norm: the step applies, the rate backs
    off to half for the next steps, and two clean steps bring it back.
    Each ``train_step`` line logs the rate its step used."""
    b = _batches(8)
    env = ('{"stats_warmup_steps": 3, "recovery_steps": 2, '
           '"watchdog": false}')
    logger = Quiet()
    g, last = _fit(b, True, env=env, monkeypatch=monkeypatch,
                   scale={4: 0.0}, logger=logger)
    rates = [f["lr"] for e, f in logger.events if e == "train_step"]
    sched = [g.lr_schedule(s) for s in range(8)]
    assert last["guardian"]["soft_anomalies"] >= 1
    assert g.step == 8 and last["guardian"]["lr_scale"] == 1.0
    assert rates[:5] == sched[:5]
    assert rates[5:7] == [sched[5] * 0.5, sched[6] * 0.5]
    assert rates[7] == sched[7]


@pytest.mark.parametrize("guardian", [False, True],
                         ids=["sigterm-unguarded", "trigger-guarded"])
def test_preempted_run_resumes_bit_identically(guardian, monkeypatch,
                                               tmp_path):
    """Preemption after the third of six steps (a real SIGTERM through an
    installed guard, or ``trigger()`` with the guardian on): the
    emergency checkpoint lands at that step, ``fit`` returns
    ``preempted``, and a resumed run ends bit for bit where the
    uninterrupted one does."""
    b = _batches(6)
    full, _ = _fit(b, guardian, ckdir=str(tmp_path / "a"),
                   monkeypatch=monkeypatch)
    guard = PreemptionGuard()

    def at_step(step):
        if step == 3:
            if guardian:
                guard.trigger()
            else:
                os.kill(os.getpid(), signal.SIGTERM)

    if not guardian:
        guard.install()
    try:
        cut, last = _fit(b, guardian, ckdir=str(tmp_path / "b"),
                         monkeypatch=monkeypatch, preempt=guard,
                         logger=Quiet(on_step=at_step))
    finally:
        guard.uninstall()
    assert last["preempted"] is True and cut.step == 3
    assert cut.ckpt.latest_step() == 3
    resumed, _ = _fit(b, guardian, ckdir=str(tmp_path / "b"),
                      monkeypatch=monkeypatch, restore=True)
    assert resumed.step == full.step == 6
    _same_state(resumed, full.model.state_dict(), _opt_tensors(full))


def test_profile_trace_captured(tmp_path, monkeypatch):
    _, tr, _ = _trainer(guardian=False, over={
        "train.profile_dir": str(tmp_path / "prof"),
        "train.profile_start_step": "0", "train.profile_steps": "1",
        "train.log_every": "1"})
    tr.fit(epochs=1)
    traces = list((tmp_path / "prof").glob("*.json"))
    assert traces and traces[0].stat().st_size > 0
    assert json.loads(traces[0].read_text())["traceEvents"]


def test_tensorboard_scalars_written(tmp_path):
    _, tr, _ = _trainer(guardian=False, over={
        "train.tensorboard_dir": str(tmp_path / "tb"),
        "train.log_every": "1"})
    tr.fit(epochs=1)
    files = list((tmp_path / "tb").glob("events.out.tfevents.*"))
    assert files and files[0].stat().st_size > 0


# -- the data pipeline's fault points ---------------------------------------------

def test_pipeline_fault_points_corrupt_and_fail():
    """``pipeline.materialize``'s ``corrupt_batch`` poisons sample 0: the
    quarantine swaps in a donor row, and with quarantine off the NaN
    flows on (the guardian's case); ``pipeline.device_prefetch``'s
    ``error`` fails the copy."""
    from deepspeech_tpu_torch.data.pipeline import (device_prefetch,
                                                    scrub_padded_batch,
                                                    scrub_samples)
    from deepspeech_tpu_torch.resilience import InjectedFault

    b = _batches(1)[0]
    faults.install(FaultPlan([FaultSpec("pipeline.materialize",
                                        "corrupt_batch", count=2)]))
    try:
        fixed, n = scrub_padded_batch({k: v.copy() for k, v in b.items()})
        assert n == 1 and np.isfinite(fixed["features"]).all()
        assert np.array_equal(fixed["features"][0], b["features"][1])
        feats, _, n = scrub_samples(
            list(b["features"]), [[1, 2]] * 4, bucket_frames=48,
            max_label_len=8, time_stride=2, enabled=False)
        assert n == 0 and np.isnan(feats[0]).all()
    finally:
        faults.clear()
    faults.install(FaultPlan([FaultSpec("pipeline.device_prefetch",
                                        "error", count=1)]))
    try:
        with pytest.raises(InjectedFault):
            next(device_prefetch([b], "cpu"))
        assert torch.equal(next(device_prefetch([b], "cpu"))["labels"],
                           torch.from_numpy(b["labels"]))
    finally:
        faults.clear()
