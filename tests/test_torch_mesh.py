"""The port's mesh and sharding rules (``parallel/mesh.py``,
``parallel/zero.py``, ``parallel/distributed.py``) against the JAX
package's ``parallel/mesh.py`` on its 8-device CPU mesh: ``make_mesh``'s
errors, ``param_spec`` / ``param_shardings`` (the tensor-parallel rule,
the ZeRO dim-0 rule, the warning fallback), ``process_local_span`` and
``process_local_rows``. In one process, no group: a ``Mesh`` of any
shape is built directly where a rule needs one."""

import logging
import types

import jax
import numpy as np
import pytest
import torch

from deepspeech_tpu.parallel import mesh as jax_mesh
from deepspeech_tpu_torch import device as port_device
from deepspeech_tpu_torch.bridge import init_params
from deepspeech_tpu_torch.config import apply_overrides, get_config
from deepspeech_tpu_torch.models import DeepSpeech2
from deepspeech_tpu_torch.ops import gru
from deepspeech_tpu_torch.parallel import comm, distributed, mesh, zero

# One CPU thread for torch: parallel test workers share the machine's
# cores, and a thread pool in each worker oversubscribes them.
torch.set_num_threads(1)


def _raised(fn):
    try:
        fn()
    except Exception as e:  # the type and text are compared
        return type(e), str(e)
    return None


@pytest.mark.parametrize("shape", [(0, 1), (1, 1), (2, 1), (1, 2), (0, 2),
                                   (2, 2, 2, 2)])
def test_make_mesh_in_one_process_is_jax_on_one_device(shape):
    """A world of one rank against JAX over one device: the same mesh
    or the same error (type and text)."""
    one = jax.devices()[:1]
    ref = _raised(lambda: jax_mesh.make_mesh(shape, devices=one))
    got = _raised(lambda: mesh.make_mesh(shape))
    assert got == ref
    if ref is None:
        m, j = mesh.make_mesh(shape), jax_mesh.make_mesh(shape, devices=one)
        assert m.shape == dict(j.shape) and m.size == 1
        assert m.data_group is None and m.model_group is None


def test_pipe_axis_names_its_item():
    """A 3-element shape once raised naming item 14c; it now builds the
    (data, pipe, model) mesh, as JAX does over one device, and a shape
    that needs more ranks raises JAX's error."""
    one = jax.devices()[:1]
    for shape in ((1, 1, 1), (0, 1, 1)):
        m, j = mesh.make_mesh(shape), jax_mesh.make_mesh(shape, devices=one)
        assert m.shape == dict(j.shape) and list(m.shape) == list(j.shape)
        assert (m.pipe, m.pipe_index, m.size) == (1, 0, 1)
        assert m.pipe_group is None and m.hops == (None, None)
    for shape in ((1, 2, 1), (2, 1, 2)):
        assert _raised(lambda: mesh.make_mesh(shape)) == _raised(
            lambda: jax_mesh.make_mesh(shape, devices=one))


@pytest.mark.parametrize("path", [
    "head/kernel", "head/bias", "rnn/layers_0/wh_f", "rnn_pipe/wx/kernel",
    "conv/conv0/kernel", "bn_out/scale", "x/head/kernel"])
def test_param_spec_is_jax(path):
    assert mesh.param_spec(path) == tuple(jax_mesh.param_spec(path))


def _params(vocab):
    cfg = apply_overrides(get_config("ds2_small"), {
        "model.rnn_hidden": "32", "model.rnn_layers": "2",
        "model.conv_channels": "4,4", "model.vocab_size": str(vocab)})
    return cfg, init_params(cfg, torch.Generator().manual_seed(0))[0]


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


@pytest.mark.parametrize("vocab", [32, 29])
@pytest.mark.parametrize("shape", [(2, 1), (1, 2), (4, 2), (8, 1)])
@pytest.mark.parametrize("zero_data_shard", [False, True])
def test_param_shardings_are_jax(vocab, shape, zero_data_shard, caplog):
    """Every leaf's spec of a ds2_small-shaped tree: the head over the
    model axis where V divides, replicated with the warning where it
    does not (the 29-way head over model=2), and under ZeRO every other
    leaf whose dim 0 divides over data (and is at least the data size)."""
    _, params = _params(vocab)
    jm = jax_mesh.make_mesh(shape)
    with caplog.at_level(logging.WARNING):
        ref = _flat(jax_mesh.param_shardings(jm, params, zero_data_shard))
        jax_warn = [r.getMessage() for r in caplog.records
                    if r.name == jax_mesh.logger.name]
        caplog.clear()
        got = _flat(mesh.param_shardings(mesh.Mesh(*shape), params,
                                         zero_data_shard))
        port_warn = [r.getMessage() for r in caplog.records
                     if r.name == mesh.logger.name]
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k] == tuple(ref[k].spec), k
    assert len(port_warn) == len(jax_warn)
    dropped = shape[1] > 1 and vocab % shape[1]
    assert bool(port_warn) == bool(dropped)
    assert all("replicating" in w and "head/" in w for w in port_warn)
    # A model axis of one rank splits nothing: the head is whole.
    assert mesh.head_sharded(mesh.Mesh(*shape), vocab) == (
        shape[1] > 1
        and ref["head/bias"].spec == jax.sharding.PartitionSpec("model"))


def test_zero_leaves_are_jax_decisions_on_the_flax_layout():
    """The parameters the port's ZeRO shards are those JAX shards over
    ``data`` (a conv kernel judged on its HWIO dim 0, split on its OIHW
    dim 2), at data=2 and data=4."""
    cfg, params = _params(29)
    model = DeepSpeech2(cfg.model)
    names = dict(model.named_parameters())
    for d in (2, 4):
        ref = _flat(jax_mesh.param_shardings(jax_mesh.make_mesh((d, 1)),
                                             params, True))
        want = {k for k, s in ref.items()
                if tuple(s.spec)[:1] == ("data",)}
        got = zero.zero_leaves(model, mesh.Mesh(d, 1))
        from deepspeech_tpu_torch.bridge import flax_path

        assert {flax_path(n, tuple(names[n].shape))[0]
                for n in got} == want
        for n, dim in got.items():
            assert dim == (2 if n.startswith("conv.") and names[n].dim() == 4
                           else 0)


@pytest.mark.parametrize("n,b", [(1, 32), (2, 32), (4, 32), (3, 10),
                                 (8, 8)])
def test_process_local_span_is_jax(n, b, monkeypatch):
    for p in range(n):
        monkeypatch.setattr(distributed, "process_index", lambda p=p: p)
        monkeypatch.setattr(distributed, "process_count", lambda n=n: n)
        monkeypatch.setattr(jax, "process_index", lambda p=p: p)
        monkeypatch.setattr(jax, "process_count", lambda n=n: n)
        assert mesh.process_local_span(b) == jax_mesh.process_local_span(b)


@pytest.mark.parametrize("shape", [(8, 1), (4, 2), (2, 4), (1, 8)])
def test_process_local_rows_are_the_jax_shardings(shape):
    """Rank r sits at mesh position (r // model, r % model), the
    process-major order of ``jax.devices()``: its rows are the slice
    JAX's batch sharding gives the device there."""
    b = 32
    jm = jax_mesh.make_mesh(shape)
    index = jax_mesh.batch_sharding(jm).devices_indices_map((b,))
    for r, dev in enumerate(jm.devices.reshape(-1)):
        s = index[dev][0]
        want = (s.start or 0, b if s.stop is None else s.stop)
        assert mesh.process_local_rows(mesh.Mesh(*shape, rank=r), b) == want
    with pytest.raises(ValueError, match="does not divide"):
        mesh.process_local_rows(mesh.Mesh(3, 1), 32)


def test_shard_batch_takes_this_ranks_rows():
    batch = {"features": np.arange(8 * 3, dtype=np.float32).reshape(8, 3),
             "feat_lens": np.arange(8, dtype=np.int32)}
    got = mesh.shard_batch(mesh.Mesh(4, 1, rank=2), batch, "cpu")
    np.testing.assert_array_equal(got["features"].numpy(),
                                  batch["features"][4:6])
    np.testing.assert_array_equal(got["feat_lens"].numpy(), [4, 5])
    whole = mesh.shard_batch(mesh.Mesh(1, 2, rank=1), batch, "cpu")
    np.testing.assert_array_equal(whole["feat_lens"].numpy(), np.arange(8))


def test_initialize_distributed_joins_only_when_asked(monkeypatch):
    """No environment, no arguments: no group (as the JAX function
    returns False outside a multi-host job); one process of a torchrun
    world of one neither."""
    for k in ("WORLD_SIZE", "MASTER_ADDR", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert distributed.initialize_distributed() is False
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    assert distributed.initialize_distributed() is False
    assert (distributed.process_count(), distributed.process_index(),
            distributed.is_primary()) == (1, 0, True)


def test_resolve_device_takes_this_ranks_card_in_a_group(monkeypatch):
    """Inside a process group ``None`` and a bare ``cuda`` mean
    ``cuda:{LOCAL_RANK}``; an explicit index is kept."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert port_device.resolve_device(None) == torch.device("cuda")
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    assert port_device.resolve_device(None) == torch.device("cuda", 3)
    assert port_device.resolve_device("cuda") == torch.device("cuda", 3)
    assert port_device.resolve_device("cuda:1") == torch.device("cuda", 1)
    assert port_device.resolve_device("cpu") == torch.device("cpu")


def test_kernels_refuse_a_tensor_off_the_current_device(monkeypatch):
    """The kernels launch on the current device: a tensor on another
    card is refused, never moved."""
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    other = types.SimpleNamespace(device=torch.device("cuda", 1))
    with pytest.raises(ValueError, match="current device is cuda:0"):
        gru.require_current(other, "gru_fwd")
    gru.require_current(types.SimpleNamespace(device=torch.device("cuda", 0)),
                        "gru_fwd")


def test_collectives_without_a_group_are_the_identity():
    x = torch.arange(6.0).reshape(2, 3).requires_grad_(True)
    for fn in (comm.all_reduce_sum, comm.copy_to_group, comm.gather_last):
        assert fn(x, None) is x
    assert comm.all_gather_dim(x, 1, None) is x
    grads = [torch.ones(2)]
    comm.all_reduce_mean_(grads, None)
    assert torch.equal(grads[0], torch.ones(2))
    assert torch.equal(comm.host_all_reduce([1, 2], None),
                       torch.tensor([1, 2]))


def test_int8_head_refuses_a_model_axis():
    """The int8 head (QWeight) is not sharded: a quantized model whose
    head would split over the model axis raises naming why; with V not
    dividing, the head is replicated and nothing is refused."""
    cfg, _ = _params(32)
    with pytest.raises(NotImplementedError, match="int8 head"):
        DeepSpeech2(cfg.model, quantized=True, mesh=mesh.Mesh(1, 2))
    cfg29, _ = _params(29)
    model = DeepSpeech2(cfg29.model, quantized=True, mesh=mesh.Mesh(1, 2))
    assert model.head_group is None
