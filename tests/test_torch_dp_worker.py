"""One rank of the data-parallel tests' worlds (tests/test_torch_dp.py);
it holds no test of its own.

``python tests/test_torch_dp_worker.py RANK WORLD INIT_URL ROOT`` joins a
gloo group through ``INIT_URL`` (a ``file://`` store), runs every case of its
world on the CPU at a tiny width, and writes what each case left into
``ROOT/<case>_<rank>.npz`` (and ``.json``). It imports no JAX: the test
process holds the results to the JAX package.

World 2 runs the two-rank cases (data parallelism, accumulation, ZeRO,
the head over the model axis, the guardian, a resume, the manifest's
rows, a dense checkpoint restored into ZeRO); world 1 runs the same step
under a one-rank group, which must give the bits of no group.
"""

import json
import logging
import os
import sys

import numpy as np
import torch

torch.set_num_threads(1)

from deepspeech_tpu_torch.bridge import init_params, to_flax  # noqa: E402
from deepspeech_tpu_torch.config import apply_overrides, get_config  # noqa
from deepspeech_tpu_torch.data import (CharTokenizer, DataPipeline,  # noqa
                                       SyntheticPipeline)
from deepspeech_tpu_torch.parallel import initialize_distributed  # noqa
from deepspeech_tpu_torch.train import Trainer  # noqa: E402

# The model and batches every case starts from: ds2_small at H=32 with
# 2 GRU layers in f32, a global batch of 8 synthetic utterances.
SMALL = {"model.rnn_hidden": "32", "model.rnn_layers": "2",
         "model.conv_channels": "4,4", "model.dtype": "float32",
         "data.batch_size": "8", "train.checkpoint_dir": "",
         "train.warmup_steps": "2", "train.grad_clip_norm": "50"}
OPTS = {"sgd": {"train.optimizer": "sgd", "train.learning_rate": "0.001"},
        "adamw": {"train.optimizer": "adamw", "train.learning_rate": "0.0001",
                  "train.weight_decay": "0.01"}}
FRAMES, LABEL_LEN = 48, 5
# case -> (overrides, optimizer): two steps each, compared with JAX.
STEP_CASES = {
    "dp_sgd": ({"train.mesh_shape": "2,1"}, "sgd"),
    "accum": ({"train.mesh_shape": "2,1", "train.accum_steps": "2"}, "sgd"),
    "zero_adamw": ({"train.mesh_shape": "2,1",
                    "train.zero_opt_sharding": "true"}, "adamw"),
    "dense_adamw": ({"train.mesh_shape": "2,1"}, "adamw"),
    "tp32": ({"train.mesh_shape": "1,2", "model.vocab_size": "32"}, "sgd"),
    "tp29": ({"train.mesh_shape": "1,2"}, "sgd"),
}
# World 1: the same steps under a one-rank group.
W1_CASES = {
    "w1_sgd": ({}, "sgd"),
    "w1_accum_zero": ({"train.accum_steps": "2",
                       "train.zero_opt_sharding": "true"}, "adamw"),
}


class Quiet:
    def log(self, event, **fields):
        pass


def config(over, opt):
    return apply_overrides(get_config("ds2_small"),
                           dict(SMALL, **OPTS[opt], **over))


def pipeline(cfg, n=16):
    return SyntheticPipeline(cfg, n, frames=FRAMES, label_len=LABEL_LEN)


def trainer(cfg, pipe, **kw):
    params, stats = init_params(cfg, torch.Generator().manual_seed(0))
    return Trainer(cfg, pipe, CharTokenizer.english(), logger=Quiet(),
                   device="cpu", params=params, batch_stats=stats, **kw)


def state_arrays(tr):
    """Parameters and BN statistics (full flax leaves), and the dense
    optimizer state by parameter name: collectives, every rank calls."""
    params, stats = to_flax(tr.model.state_dict(), tr.model.head_group)
    out = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            else:
                out[f"{prefix}{k}"] = np.asarray(v)

    walk({"params": params, "batch_stats": stats}, "")
    names = [n for n, _ in tr.model.named_parameters()]
    for i, st in tr.optimizer_state_dict()["state"].items():
        for k, v in st.items():
            out[f"opt/{names[i]}/{k}"] = v.detach().cpu().numpy()
    return out


def save(root, case, rank, arrays, meta=None):
    np.savez(os.path.join(root, f"{case}_{rank}.npz"), **arrays)
    with open(os.path.join(root, f"{case}_{rank}.json"), "w") as fh:
        json.dump(meta or {}, fh)


def step_case(root, rank, case, over, opt):
    cfg = config(over, opt)
    pipe = pipeline(cfg)
    records = []
    handler = logging.Handler()
    handler.emit = lambda r: records.append(r.getMessage())
    mesh_log = logging.getLogger("deepspeech_tpu_torch.parallel.mesh")
    mesh_log.addHandler(handler)
    try:
        tr = trainer(cfg, pipe)
    finally:
        mesh_log.removeHandler(handler)
    metrics = [{k: float(v) for k, v in tr.train_step(b).items()}
               for b in pipe.batches]
    save(root, case, rank, state_arrays(tr),
         {"metrics": metrics, "warnings": records,
          "head_sharded": tr.model.head_group is not None,
          # The BN statistics' group and the ZeRO leaves: what runs
          # collectives under a group.
          "bn_grouped": tr.model.bn_out.group is not None,
          "zero_leaves": len(tr._zero),
          # Greedy WER/CER over the rows (the English tokenizer's V).
          "eval": tr.evaluate() if case == "dp_sgd" else None})


def guard_case(root, rank):
    """Three guarded steps, the second with rank 1's rows poisoned."""
    cfg = config({"train.mesh_shape": "2,1", "train.guardian": "true"},
                 "sgd")
    pipe = pipeline(cfg, 24)
    tr = trainer(cfg, pipe)
    b0, b1, b2 = pipe.batches
    poisoned = {k: v.copy() for k, v in b1.items()}
    poisoned["features"][4:] = np.nan
    applied, same = [], None
    for b in (b0, poisoned, b2):
        before = {k: v.clone() for k, v in tr.model.state_dict().items()}
        opt_before = [(k, v.clone()) for st in
                      tr.optimizer.state_dict()["state"].values()
                      for k, v in sorted(st.items())]
        m = tr.train_step(b)
        ok = bool(m["applied"])
        tr.commit_step(ok)
        applied.append(ok)
        if b is poisoned:
            opt_after = [(k, v) for st in
                         tr.optimizer.state_dict()["state"].values()
                         for k, v in sorted(st.items())]
            same = (all(torch.equal(before[k], v)
                        for k, v in tr.model.state_dict().items())
                    and len(opt_before) == len(opt_after)
                    and all(ka == kb and torch.equal(a, b) for (ka, a),
                            (kb, b) in zip(opt_before, opt_after)))
    save(root, "guard", rank, state_arrays(tr),
         {"applied": applied, "skip_kept_state": same, "step": tr.step})


class StopAt:
    """A preemption request once the trainer reaches ``step``."""

    def __init__(self, step):
        self.step, self.trainer = step, None

    def requested(self):
        return self.trainer.step >= self.step


def resume_case(root, rank):
    """ZeRO AdamW for 2 epochs of 4 steps with checkpoints; a run stopped
    at step 5 (mid-epoch) and resumed must end with the same bits."""
    over = {"train.mesh_shape": "2,1", "train.zero_opt_sharding": "true",
            "train.epochs": "2", "train.checkpoint_every_steps": "3"}
    out = {}
    for name in ("full", "cut", "resumed"):
        d = os.path.join(root, "ck_full" if name == "full" else "ck_cut")
        cfg = config(dict(over, **{"train.checkpoint_dir": d}), "adamw")
        stop = StopAt(5) if name == "cut" else None
        tr = trainer(cfg, pipeline(cfg, 32), preempt=stop)
        if stop is not None:
            stop.trainer = tr
        if name == "resumed":
            tr.maybe_restore()
            out["restored_at"] = [tr.step, tr.start_epoch]
        last = tr.fit()
        out[name] = {"step": tr.step, "preempted": bool(last.get("preempted"))}
        arrays = state_arrays(tr)
        if name != "cut":
            save(root, f"resume_{name}", rank, arrays)
    save(root, "resume", rank, {}, out)


def rows_case(root, rank, manifest):
    """This rank's rows of the first training batch and the first eval
    batch of a WAV manifest."""
    cfg = apply_overrides(get_config("ds2_small"), {
        "data.batch_size": "4", "data.bucket_frames": "100,200",
        "data.max_duration_s": "2.0"})
    pipe = DataPipeline(cfg, CharTokenizer.english(), manifest)
    plan = next(iter(pipe.sampler.epoch(0)))
    train = pipe._materialize(plan, epoch=0)
    ev, n_valid = next(iter(pipe.eval_epoch()))
    save(root, "rows", rank,
         {**{f"train/{k}": v for k, v in train.items()},
          **{f"eval/{k}": v for k, v in ev.items()}},
         {"n_valid": n_valid})


def restore_case(root, rank):
    """A dense checkpoint (written by one process) restored into ZeRO
    over two ranks, gathered back."""
    cfg = config({"train.mesh_shape": "2,1", "train.zero_opt_sharding": "true",
                  "train.checkpoint_dir": os.path.join(root, "ck_dense")},
                 "adamw")
    tr = trainer(cfg, pipeline(cfg))
    tr.maybe_restore()
    # This rank's rows of each ZeRO leaf, as the optimizer holds them.
    names = [n for n, _ in tr.model.named_parameters()]
    rows = {f"rows/{names[i]}/{k}": v.numpy()
            for i, st in tr.optimizer.state_dict()["state"].items()
            if i in tr._zero for k, v in st.items() if v.dim()}
    save(root, "restore", rank, {**state_arrays(tr), **rows},
         {"step": tr.step, "zero": {names[i]: [s.dim, s.lo, s.n]
                                    for i, s in tr._zero.items()}})


def mismatch_case(root, rank):
    """Rank 1 seeds its init otherwise: every rank's Trainer refuses."""
    cfg = config({"train.mesh_shape": "2,1"}, "sgd")
    params, stats = init_params(cfg, torch.Generator().manual_seed(rank))
    try:
        Trainer(cfg, pipeline(cfg), CharTokenizer.english(), logger=Quiet(),
                device="cpu", params=params, batch_stats=stats)
        error = ""
    except ValueError as e:
        error = str(e)
    save(root, "mismatch", rank, {}, {"error": error})


def main():
    rank, world, url, root = (int(sys.argv[1]), int(sys.argv[2]),
                              sys.argv[3], sys.argv[4])
    os.environ.pop("DS2_GUARDIAN", None)
    initialize_distributed(url, world, rank, device="cpu")
    if world == 1:
        for case, (over, opt) in W1_CASES.items():
            step_case(root, rank, case, over, opt)
        return
    for case, (over, opt) in STEP_CASES.items():
        step_case(root, rank, case, over, opt)
    guard_case(root, rank)
    resume_case(root, rank)
    rows_case(root, rank, os.path.join(root, "train.jsonl"))
    restore_case(root, rank)
    mismatch_case(root, rank)


if __name__ == "__main__":
    main()
