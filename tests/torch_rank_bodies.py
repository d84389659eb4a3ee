"""What each spawned rank of the port's parallel tests runs.

These functions run inside ranks that ``med_tpu_torch.parallel.launch.spawn``
starts (gloo on the CPU, a ``FileStore`` rendezvous in the test's temporary
directory). A rank imports only torch, numpy and the port: never JAX nor
``med_tpu``. Each returns numpy results that the test compares in its own
process, against the port on one rank and against ``med_tpu``.
"""

import os

import numpy as np
import torch

from med_tpu_torch.config import ExperimentConfig
from med_tpu_torch.parallel import comm, launch
from med_tpu_torch.parallel.mesh import _gather, make_mesh, shard_state
from med_tpu_torch.train.engine import Experiment


def _np(t):
    return t.detach().cpu().numpy().copy()


def _read_out(y, x, w):
    """(y, the gradient of sum(y * w) at x); zeros where y holds none of x
    (a shift past the whole sequence)."""
    if y.requires_grad:
        (y * w).sum().backward()
    return _np(y), _np(x.grad) if x.grad is not None else np.zeros(tuple(x.shape), np.float32)


def _grads(exp):
    """Every parameter's gradient, whole (tensor-parallel slices gathered)."""
    out = {}
    for name, p in exp.net.named_parameters():
        g = p.grad
        if name in exp.tp:
            g = _gather(g, exp.tp[name], exp.mesh.group("model"))
        out[name] = _np(g)
    return out


# ------------------------------------------------------------------ comm
def comm_suite(T: int, C: int, offsets, widths):
    """Each collective on this rank's block of seeded global arrays, with the
    gradients of a seeded linear read-out of its output."""
    mesh = make_mesh((launch.world_size(), 1))
    g = mesh.group("data")
    n, i = launch.world_size(), launch.rank()
    S = T // n
    rng = np.random.default_rng(0)
    x_all = rng.normal(size=(T, C)).astype(np.float32)
    w_all = rng.normal(size=(T, C)).astype(np.float32)
    rows = slice(i * S, (i + 1) * S)
    out = {}

    for mode in ("identity", "sum"):
        x = torch.tensor(x_all[rows], requires_grad=True)
        y = comm.psum(x, g, grad=mode)
        out[f"psum_{mode}"] = _read_out(y, x, torch.tensor(w_all[rows]))

    for off in offsets:
        x = torch.tensor(x_all[rows], requires_grad=True)
        y = comm.seq_shift_right(x, off, g)
        out[f"shift_{off}"] = _read_out(y, x, torch.tensor(w_all[rows]))

    fill = torch.tensor(rng.normal(size=C).astype(np.float32))
    for width in widths:
        x = torch.tensor(x_all[rows], requires_grad=True)
        h = comm.halo_left(x, width, g, fill_row=fill)
        wh = torch.tensor(np.random.default_rng(100 + i).normal(size=(width, C))
                          .astype(np.float32))
        out[f"halo_{width}"] = _read_out(h, x, wh)

    x = torch.tensor(x_all[rows], requires_grad=True)
    out["gather"] = _read_out(comm.all_gather(x, g), x, torch.tensor(w_all))
    out["far"] = _np(comm.fetch(torch.tensor(x_all[rows]), -n, g))
    return out


# ------------------------------------------------------------ data/tensor
def window_dp_suite(fields, tree, batch, masks, shapes):
    """:func:`window_dp_step` on each mesh shape of this world."""
    return [window_dp_step(fields, tree, batch, masks, shape) for shape in shapes]


def window_dp_step(fields, tree, batch, masks, shape):
    """One DP/TP window step from ``tree``'s weights with the whole batch's
    dropout ``masks`` (each rank takes its rows), then the eval step."""
    exp = Experiment(ExperimentConfig(**fields), device="cpu")
    exp.load_params(tree)
    shard_state(exp, make_mesh(shape))
    m = exp.train_step(batch, masks=[torch.as_tensor(k) for k in masks])
    grads = _grads(exp)
    with torch.no_grad():
        stats = {k: _np(v) for k, v in exp.net.state_dict().items() if "running" in k}
    ev = exp.eval_step(batch)
    return {"loss": float(m["loss"]), "cm": _np(m["cm"]), "preds": _np(m["preds"]),
            "grads": grads, "stats": stats, "eval_loss": float(ev["loss"]),
            "eval_preds": _np(ev["preds"]), "eval_cm": _np(ev["cm"]), "tp": sorted(exp.tp)}


def trial_dp_suite(fields, tree, groups, masks, shape):
    """Trial-DP steps on whole trial groups (the last one short, padded with
    zero-weight repeats): each group's loss, cm and gradients, then the
    eval step on the first group."""
    exp = Experiment(ExperimentConfig(**fields), device="cpu")
    exp.load_params(tree)
    shard_state(exp, make_mesh(shape))
    out = []
    for group, mk in zip(groups, masks):
        mk = {s: {k: torch.as_tensor(v) for k, v in st.items()} for s, st in mk.items()}
        loss, m = exp.compute_gradients(group, masks=mk)
        out.append({"loss": float(loss), "cm": _np(m["cm"]), "grads": _grads(exp)})
    ev = exp.eval_step(groups[0])
    return out, {"loss": float(ev["loss"]), "preds": _np(ev["preds"]), "cm": _np(ev["cm"])}


def finetune_dp_suite(state, kw, strides, imgs, labels, mask, stats):
    """One ``cli.resnet_finetune.train_step`` (float64, train-mode BN, no
    augmentation) of a classifier of the given ``kw`` and state on this
    rank's rows of the batch over a (n, 1) mesh, for each ghost stride:
    the global loss, every gradient (summed over the ranks) and every
    running statistic."""
    from med_tpu_torch.cli.resnet_finetune import train_step
    from med_tpu_torch.models.resnet import ResNetClassifier

    mesh = make_mesh((launch.world_size(), 1))
    out = {}
    for stride in strides:
        net = ResNetClassifier(bn_stat_stride=stride, dtype=torch.float64, **kw)
        net.load_state_dict(state)
        net.double()
        opt = torch.optim.Adam(net.parameters(), lr=1e-3, betas=(0.9, 0.999), eps=1e-8)
        loss = train_step(net, opt, imgs, labels, mask, stats, False, None, mesh)
        out[stride] = (float(loss), {n: _np(p.grad) for n, p in net.named_parameters()},
                       {n: _np(b) for n, b in net.named_buffers()})
    return out


def mesh_suite(window_args, trial_args):
    """The window DP/TP steps and the trial-DP steps in one group."""
    return window_dp_suite(*window_args), trial_dp_suite(*trial_args)


# ------------------------------------------------------------------- SP
def _sp_exp(fields, tree, frozen=None, dtype=None):
    exp = Experiment(ExperimentConfig(**fields), device="cpu")
    exp.load_params(tree)
    if frozen is not None:
        exp.load_frozen(frozen)
    if dtype is not None:
        exp.net.to(dtype)
        exp.frozen = None if exp.frozen is None else exp.frozen.to(dtype)
    return exp


def sp_suite(kind, fields, tree, x, labels, mask, masks, frozen=None, dropout_rate=0.5):
    """An SP forward and backward of TeCNo, COG or TransSVNet on this rank's
    time block (the whole trial's dropout ``masks``, drawn at
    ``dropout_rate``, cut to it): the loss, the all-reduced gradients, the
    final track's gathered logits."""
    from med_tpu_torch.parallel.seqpar import shard_sequence, sp_tecno_forward, sp_tecno_loss
    from med_tpu_torch.parallel.sp_cog import sp_cog_forward, sp_cog_loss
    from med_tpu_torch.parallel.sp_tsvn import sp_tsvn_forward, sp_tsvn_loss

    dtype = torch.float64 if kind == "tsvn" else None
    exp = _sp_exp(fields, tree, frozen, dtype)
    model = exp.net.model
    g = make_mesh((launch.world_size(), 1)).group("data")
    xl = shard_sequence(torch.as_tensor(x), g).to(dtype or torch.float32)
    yl, ml = shard_sequence(torch.as_tensor(labels), g), shard_sequence(torch.as_tensor(mask), g)
    if kind == "tecno":
        mk = None if masks is None else {k: shard_sequence(torch.as_tensor(v), g, axis=1)
                                         for k, v in masks.items()}
        loss = sp_tecno_loss(model, xl, yl, ml, g, mk, dropout_rate)
        with torch.no_grad():
            final = sp_tecno_forward(model, xl, g, mk, dropout_rate)[-1]
    elif kind == "cog":
        mk = None
        if masks is not None:
            mk = {name: {k: (torch.as_tensor(v) if k == "channel"
                             else shard_sequence(torch.as_tensor(v), g, axis=1))
                         for k, v in st.items()} for name, st in masks.items()}
        loss = sp_cog_loss(model, xl, yl, g, exp.cfg.smooth_lambda, dropout=mk)
        with torch.no_grad():
            final = sp_cog_forward(model, xl, g, mk)[0]
    else:
        loss = sp_tsvn_loss(model, exp.frozen, xl, yl, ml, g)
        with torch.no_grad():
            tecno = sp_tecno_forward(exp.frozen, xl, g)[-1]
            final = sp_tsvn_forward(model, tecno, xl, g)
    loss.backward()
    comm.all_reduce_grads(model.parameters(), g)
    out = {"loss": float(loss.detach()), "final": _np(comm.all_gather(final, g)),
           "grads": {k: _np(p.grad) for k, p in model.named_parameters()}}
    if kind == "tecno" and dropout_rate == 0.5:
        # the SP train step of make_sp_tecno_train_step, SGD at lr 0.1 from
        # the same weights: its loss, and the weights it leaves
        from med_tpu_torch.parallel.seqpar import make_sp_tecno_train_step

        exp = _sp_exp(fields, tree)
        opt = torch.optim.SGD(exp.net.model.parameters(), lr=0.1)
        step = make_sp_tecno_train_step(exp.net.model, opt, g)
        out["step_loss"] = float(step(xl, yl, ml, 0, masks={
            k: torch.as_tensor(v) for k, v in masks.items()}))
        out["stepped"] = {k: _np(p) for k, p in exp.net.model.named_parameters()}
    return out


def seqpar_suite(cases):
    """:func:`sp_suite` for each (kind, fields, tree, x, labels, mask, masks,
    frozen) case, in one group."""
    return [sp_suite(*case) for case in cases]


def sp_fold_suite(fields, train, test, bucket, snapshot_dir, tag):
    """``train_sp_frame_fold`` over this world's ranks, on ``bucket``; rank 0
    keeps the fold's last_state snapshot under ``snapshot_dir``."""
    from med_tpu_torch.parallel.sp_train import train_sp_frame_fold

    class _Tracker:
        def checkpoint_path(self, name):
            return f"{snapshot_dir}/{name}"

        def log_metrics(self, *a, **k):
            pass

    cfg = ExperimentConfig(**fields)
    res = train_sp_frame_fold(cfg, train, test, make_mesh((launch.world_size(), 1)),
                              device="cpu", bucket=bucket, tracker=_Tracker(), tag=tag)
    return {"history": res["history"], "preds": res["best"]["preds"],
            "checkpoint": res["checkpoint"]}


def sp_masked_suite(fields, batches, masks):
    """SPFrameTrainer's loss and gradients on whole padded trials (COG's
    per-track targets made on the host), with the given whole-trial
    dropout masks cut to this rank's rows."""
    from med_tpu_torch.parallel.seqpar import shard_sequence
    from med_tpu_torch.parallel.sp_train import SPFrameTrainer

    trainer = SPFrameTrainer(ExperimentConfig(**fields), make_mesh((launch.world_size(), 1)),
                             device="cpu")
    trainer.exp.init_weights(3)
    g = trainer.group
    out = []
    for batch, mk in zip(batches, masks):
        local = trainer.shard(batch)
        dp = {name: {k: (torch.as_tensor(v) if k == "channel"
                         else shard_sequence(torch.as_tensor(v), g, axis=1))
                     for k, v in st.items()} for name, st in mk.items()}
        trainer.exp.optimizer.zero_grad(set_to_none=False)
        loss, _ = trainer._forward_loss(local, dp)
        loss.backward()
        comm.all_reduce_grads(trainer.exp.net.parameters(), g)
        out.append({"loss": float(loss.detach()),
                    "grads": {k: _np(p.grad) for k, p in trainer.exp.net.named_parameters()}})
    return out


def sp_train_suite(fold_args, masked_cases):
    """An SP fold and the masked SP COG losses of each case in one group."""
    return sp_fold_suite(*fold_args), [sp_masked_suite(*case) for case in masked_cases]


# -------------------------------------------------------------- pipeline
def pipeline_suite(fields, tree, x, labels, mask, masks, steps: int, lr: float,
                   rate: float = 0.5):
    """``steps`` pipelined TeCNo train steps (rank d holds stage d + 1), SGD
    at ``lr``, with dropout at ``rate`` by ``masks`` where there are masks:
    the losses and every stage's weights after them."""
    from med_tpu_torch.parallel.pipeline import make_pp_tecno_train_step, pipeline_refine

    exp = Experiment(ExperimentConfig(**fields), device="cpu")
    exp.load_params(tree)
    model = exp.net.model
    g = make_mesh((launch.world_size(), 1)).group("data")
    d = launch.rank()
    stage0, stage = model.stage0, model.stages()[d + 1]
    with torch.no_grad():
        out0 = torch.stack([stage0(torch.as_tensor(xm)[None])[1][0] for xm in x])
        forward = _np(pipeline_refine(stage, out0, g))
    opt0 = torch.optim.SGD(stage0.parameters(), lr=lr)
    opt1 = torch.optim.SGD(stage.parameters(), lr=lr)
    step = make_pp_tecno_train_step(stage0, stage, opt0, opt1, g,
                                    dropout_rate=rate if masks is not None else 0.0)
    mk = None if masks is None else {k: torch.as_tensor(v) for k, v in masks.items()}
    losses = [float(step(torch.as_tensor(x), torch.as_tensor(labels), torch.as_tensor(mask),
                         mk)) for _ in range(steps)]
    return {"forward": forward, "losses": losses,
            "stage0": {k: _np(v) for k, v in stage0.state_dict().items()},
            "stage": {k: _np(v) for k, v in stage.state_dict().items()}}


def pipeline_cases(cases):
    """:func:`pipeline_suite` for each case, in one group."""
    return [pipeline_suite(*case) for case in cases]


# ------------------------------------------------------------------- CLI
def cli_suite(runs):
    """Each (module, argv) CLI's ``main`` on this rank of the world (rank 0
    writes the run): its per-fold predictions, test F1 and cm, and the run
    directory."""
    import importlib

    out = []
    for module, argv in runs:
        results, tracker = importlib.import_module(module).main(argv)
        out.append(({k: {"preds": np.asarray(v["preds"]), "test_f1": v["test_f1"],
                         "cm": np.asarray(v["cm"])} for k, v in results.items()}, tracker.dir))
    return out


def serve_suite(fields, tree, images, kinematics):
    """An EnsembleServer of one window member on this world's mesh: each
    rank serves its rows, every rank gets the whole batch's outputs."""
    from med_tpu_torch.eval.serving import EnsembleServer, WindowModelBundle

    member = WindowModelBundle(ExperimentConfig(**fields), tree, device="cpu")
    server = EnsembleServer([member], mesh=make_mesh((launch.world_size(), 1)))
    return server.predict(images, kinematics)


def folds_suite(runs, serve_args):
    """The CLIs of :func:`cli_suite`, then :func:`serve_suite`, in one group."""
    return cli_suite(runs), serve_suite(*serve_args)


# --------------------------------------------------------------- threads
def thread_suite():
    """This rank's torch intra-op count and the OMP_NUM_THREADS it was
    started with."""
    return torch.get_num_threads(), os.environ.get("OMP_NUM_THREADS")
