"""One rank of the pipeline-parallel tests' worlds
(tests/test_torch_pipeline.py); it holds no test of its own.

``python tests/test_torch_pipeline_worker.py RANK WORLD INIT_URL ROOT
SHAPE`` joins a gloo group through ``INIT_URL`` (a ``file://`` store),
runs every case of the ``(data, pipe, model)`` mesh ``SHAPE`` (``1,2,1``,
``2,2,1`` or ``1,3,1``) on the CPU at a tiny width, and writes what each
case left into ``ROOT/<case>_<rank>.npz`` (and ``.json``). It imports no
JAX: the test process holds the results to the JAX package. The model
cases read their weights from ``ROOT/w_<case>.npz`` and the inputs from
``ROOT/inputs.npz``, which the test process wrote.
"""

import json
import os
import sys

import numpy as np
import torch

torch.set_num_threads(1)

from deepspeech_tpu_torch.bridge import (from_flax, init_params,  # noqa
                                         load_npz, to_flax)
from deepspeech_tpu_torch.config import apply_overrides, get_config  # noqa
from deepspeech_tpu_torch.data import (CharTokenizer,  # noqa: E402
                                       SyntheticPipeline)
from deepspeech_tpu_torch.models.ds2 import DeepSpeech2  # noqa: E402
from deepspeech_tpu_torch.parallel import (initialize_distributed,  # noqa
                                           make_mesh)
from deepspeech_tpu_torch.train import Trainer  # noqa: E402

# tests/test_pipeline_pp.py's model: dev_slice at 3 layers of 32 units
# (layers 1-2 stacked), 4+4 conv channels, float32, two stages, a batch
# of 8 at 64 frames; the English vocabulary, so that evaluate decodes.
BASE = {"model.rnn_layers": "3", "model.rnn_hidden": "32",
        "model.conv_channels": "4,4", "model.vocab_size": "29",
        "model.dtype": "float32", "model.pipeline_stages": "2",
        "data.batch_size": "8", "data.bucket_frames": "64",
        "data.max_label_len": "8", "train.checkpoint_dir": "",
        "train.warmup_steps": "2", "train.optimizer": "sgd",
        "train.learning_rate": "0.001", "train.grad_clip_norm": "1.0"}
FRAMES, LABEL_LEN, N_UTTS = 64, 4, 16


def m(k):
    return {"model.pipeline_microbatches": str(k)}


# case -> (mesh shape, overrides, kind): "eval" (logits in eval mode),
# "grad" (mean(logits^2) in train mode: its value, the gradients and the
# BN statistics after it), "trainer" (two Trainer steps, CTC and SGD).
CASES = {
    "eval_m1": ((1, 2, 1), m(1), "eval"),
    "eval_m2": ((1, 2, 1), m(2), "eval"),
    "eval_m4": ((1, 2, 1), m(4), "eval"),
    "eval_nobn": ((1, 2, 1), dict(m(2), **{"model.rnn_batch_norm":
                                           "false"}), "eval"),
    "grad_m1": ((1, 2, 1), m(1), "grad"),
    "grad_m2": ((1, 2, 1), m(2), "grad"),
    "grad_m4": ((1, 2, 1), m(4), "grad"),
    "grad_lstm": ((1, 2, 1), dict(m(2), **{"model.rnn_type": "lstm"}),
                  "grad"),
    "grad_nobn": ((1, 2, 1), dict(m(2), **{"model.rnn_batch_norm":
                                           "false"}), "grad"),
    "grad_uni": ((1, 2, 1), dict(m(2), **{"model.bidirectional": "false"}),
                 "grad"),
    "grad_bf16": ((1, 2, 1), dict(m(2), **{"model.dtype": "bfloat16"}),
                  "grad"),
    "trainer_m2": ((1, 2, 1), dict(m(2), **{"train.mesh_shape": "1,2,1"}),
                   "trainer"),
    "trainer_accum": ((1, 2, 1), dict(m(2), **{"train.mesh_shape": "1,2,1",
                                               "train.accum_steps": "2"}),
                      "trainer"),
    "trainer_dp": ((2, 2, 1), dict(m(2), **{"train.mesh_shape": "2,2,1"}),
                   "trainer"),
    "grad_p3": ((1, 3, 1), dict(m(4), **{"model.rnn_layers": "4",
                                         "model.pipeline_stages": "3"}),
                "grad"),
}
# The resume run's overrides: 2 epochs of 2 steps, a checkpoint every 2.
RESUME = dict(m(2), **{"train.mesh_shape": "1,2,1", "train.epochs": "2",
                       "train.checkpoint_every_steps": "2"})


class Quiet:
    def log(self, event, **fields):
        pass


def config(over):
    return apply_overrides(get_config("dev_slice"), dict(BASE, **over))


def pipeline(cfg):
    return SyntheticPipeline(cfg, N_UTTS, frames=FRAMES, label_len=LABEL_LEN)


def trainer(cfg, pipe, **kw):
    params, stats = init_params(cfg, torch.Generator().manual_seed(0))
    return Trainer(cfg, pipe, CharTokenizer.english(), logger=Quiet(),
                   device="cpu", params=params, batch_stats=stats, **kw)


def flat(tree, prefix):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def model_arrays(model):
    """Parameters and BN statistics, the stages gathered: collectives,
    every rank calls."""
    params, stats = to_flax(model.state_dict(), model.head_group,
                            model.pipe_group)
    return {**flat(params, "params/"), **flat(stats, "batch_stats/")}


def state_arrays(tr):
    """``model_arrays`` and the dense optimizer state by parameter name."""
    out = model_arrays(tr.model)
    names = [n for n, _ in tr.model.named_parameters()]
    for i, st in tr.optimizer_state_dict()["state"].items():
        for k, v in st.items():
            out[f"opt/{names[i]}/{k}"] = v.detach().cpu().numpy()
    return out


def local_layers(model):
    """The stacked layers this rank holds, leaf by leaf, and its stage."""
    stack = model.rnn_pipe
    return {"rows": {n: int(getattr(stack, n).shape[0])
                     for n in stack.names + ["mean", "var"]
                     if hasattr(stack, n)},
            "stage": stack.stage}


def save(root, case, rank, arrays, meta=None):
    np.savez(os.path.join(root, f"{case}_{rank}.npz"), **arrays)
    with open(os.path.join(root, f"{case}_{rank}.json"), "w") as fh:
        json.dump(meta or {}, fh)


def inputs(root):
    with np.load(os.path.join(root, "inputs.npz")) as z:
        return (torch.from_numpy(z["features"]),
                torch.from_numpy(z["feat_lens"]).long())


def eval_logits(model, feats, lens):
    model.eval()
    with torch.no_grad():
        return model(feats, lens)[0].numpy()


def model_case(root, rank, case, shape, over, kind):
    cfg = config(over)
    params, stats = load_npz(os.path.join(root, f"w_{case}.npz"))
    model = DeepSpeech2(cfg.model, mesh=make_mesh(shape))
    model.load_state_dict(from_flax(params, stats, model.head_group,
                                    model.pipe_group))
    feats, lens = inputs(root)
    meta = local_layers(model)
    if kind == "eval":
        save(root, case, rank, {"logits": eval_logits(model, feats, lens)},
             meta)
        return
    model.train()
    logits, _ = model(feats, lens)
    loss = logits.float().square().mean()
    loss.backward()
    grads, _ = to_flax({n: p.grad for n, p in model.named_parameters()},
                       model.head_group, model.pipe_group)
    arrays = {**model_arrays(model), **flat(grads, "grads/"),
              "loss": loss.detach().numpy(),
              "logits": logits.detach().float().numpy()}
    save(root, case, rank, arrays, meta)


def trainer_case(root, rank, case, over):
    """Two steps; the M=2 case also checkpoints, evaluates and keeps the
    eval logits of the model it ends with."""
    ck = os.path.join(root, "ck_m2") if case == "trainer_m2" else ""
    cfg = config(dict(over, **{"train.checkpoint_dir": ck}))
    pipe = pipeline(cfg)
    tr = trainer(cfg, pipe)
    metrics = [{k: float(v) for k, v in tr.train_step(b).items()}
               for b in pipe.batches]
    arrays = state_arrays(tr)
    meta = {"metrics": metrics, **local_layers(tr.model),
            "opt_rows": {n: int(v.shape[0]) for n, v in zip(
                [n for n, _ in tr.model.named_parameters()],
                tr.opt_params) if n.startswith("rnn_pipe.")}}
    if ck:
        tr.save(1)
        tr._wait_saved()
        meta["eval"] = tr.evaluate()
        arrays["eval_logits"] = eval_logits(tr.model, *inputs(root))
    save(root, case, rank, arrays, meta)


class StopAt:
    """A preemption request once the trainer reaches ``step``."""

    def __init__(self, step):
        self.step, self.trainer = step, None

    def requested(self):
        return self.trainer.step >= self.step


def resume_case(root, rank):
    """2 epochs of 2 steps with checkpoints: a run stopped at step 3
    (mid-epoch 1) and resumed must end with the uninterrupted run's
    bits."""
    out = {}
    for name in ("full", "cut", "resumed"):
        d = os.path.join(root, "ck_full" if name == "full" else "ck_cut")
        cfg = config(dict(RESUME, **{"train.checkpoint_dir": d}))
        stop = StopAt(3) if name == "cut" else None
        tr = trainer(cfg, pipeline(cfg), preempt=stop)
        if stop is not None:
            stop.trainer = tr
        if name == "resumed":
            tr.maybe_restore()
            out["restored_at"] = [tr.step, tr.start_epoch]
        last = tr.fit()
        out[name] = {"step": tr.step,
                     "preempted": bool(last.get("preempted"))}
        arrays = state_arrays(tr)
        if name != "cut":
            save(root, f"resume_{name}", rank, arrays)
    save(root, "resume", rank, {}, out)


def main():
    rank, world, url, root, shape = (int(sys.argv[1]), int(sys.argv[2]),
                                     sys.argv[3], sys.argv[4],
                                     tuple(int(x) for x in
                                           sys.argv[5].split(",")))
    os.environ.pop("DS2_GUARDIAN", None)
    initialize_distributed(url, world, rank, device="cpu")
    for case, (case_shape, over, kind) in CASES.items():
        if case_shape != shape:
            continue
        if kind == "trainer":
            trainer_case(root, rank, case, over)
        else:
            model_case(root, rank, case, shape, over, kind)
    if shape == (1, 2, 1):
        resume_case(root, rank)


if __name__ == "__main__":
    main()
