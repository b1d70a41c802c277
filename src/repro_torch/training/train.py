"""Training step: cross-entropy loss + AdamW update (the port of
``repro/training/train.py``).

``make_train_step(model, opt)`` builds ``train_step(params, opt_state,
batch) -> (params, opt_state, metrics)``: ``params`` is the model's
parameters by name (``model.init``'s result), updated in place by the
optimizer and returned, ``metrics`` 0-d tensors (``loss``, ``aux``,
``total``) left on the model's device. The gradient is autograd's
through the model's forward, which on the card runs the hand-written
kernels both ways (``kernels.ops.flash_attention`` and
``kernels.ops.ssd_diag`` and their backward kernels).

On a model whose parameters are DTensors (``sharding.place``) the same
step runs on DTensors: the gradients take the parameters' placements,
the loss is replicated before the backward, and the metrics come back
as the plain tensors every rank holds.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.models import runtime as RT
from repro_torch.models.model import Model

F32 = torch.float32


def cross_entropy(logits: torch.Tensor, labels, *, mask=None):
    """Mean token cross-entropy, float32 logsumexp; with ``mask`` the
    masked mean (at least one token's weight in the denominator)."""
    logits = logits.to(F32)
    lse = torch.logsumexp(logits, dim=-1)
    if not isinstance(labels, DTensor):
        labels = torch.as_tensor(labels, device=logits.device)
    gold = gold_logits(logits, labels.long())
    nll = lse - gold
    if mask is not None:
        mask = torch.as_tensor(mask, device=logits.device).to(F32)
        return torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)
    return torch.mean(nll)


def gold_logits(logits, labels):
    """``logits[..., labels]``. On DTensor logits whose vocab dim is
    sharded (the unembedding's "tp" columns), each rank reads the labels
    that fall in its block of the vocabulary, and the blocks sum
    (``Partial``): the logits are never gathered."""
    if not isinstance(logits, DTensor):
        return torch.gather(logits, -1, labels[..., None])[..., 0]
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.sharding.rules import local_block
    mesh, last = logits.device_mesh, logits.ndim - 1
    vocab = [isinstance(p, Shard) and p.dim == last
             for p in logits.placements]
    pl = [Replicate() if p.is_partial() else p for p in logits.placements]
    lab = [Replicate() if v else p for v, p in zip(vocab, pl)]
    out = [Partial() if v else p for v, p in zip(vocab, pl)]
    lo, n = local_block(logits.shape[last], mesh, pl, last)

    def local(lg, lb):
        idx = lb - lo
        inside = (idx >= 0) & (idx < n)
        got = torch.gather(lg, -1, idx.clamp(0, max(n - 1, 0))[..., None])
        return torch.where(inside, got[..., 0], 0.0)
    return local_map(local, out_placements=out, in_placements=(pl, lab),
                     device_mesh=mesh, redistribute_inputs=True)(logits,
                                                                 labels)


def replicated(t):
    """A DTensor result (a loss, a metric) as the plain tensor every rank
    holds; a plain tensor as it is."""
    return t.full_tensor() if isinstance(t, DTensor) else t


def make_loss_fn(model: Model):
    """``loss_fn(batch) -> (loss + aux, {"loss", "aux"})`` through the
    model's teacher-forced forward."""
    def loss_fn(batch: dict):
        logits, aux = model.forward(batch)
        loss = cross_entropy(logits, batch["labels"],
                             mask=batch.get("loss_mask"))
        return loss + aux, {"loss": loss, "aux": aux}
    return loss_fn


def _split(batch: dict, micro: int) -> list[dict]:
    """``micro`` batches of equal rows, in order (the reference's reshape
    to (micro, B / micro, ...)). A DTensor whose rows are sharded is split
    on each rank's own block, so that every microbatch keeps the batch's
    placements: microbatch i holds the i-th part of every rank's rows (a
    slice of the global rows would be gathered, and every rank would run
    rows of the others)."""
    out = [dict() for _ in range(micro)]
    for k, v in batch.items():
        rows = v.to_local().shape[0] if _rows_sharded(v) else v.shape[0]
        if rows % micro:
            raise ValueError(f"batch of {rows} rows does not split into "
                             f"{micro} microbatches")
        step = rows // micro
        for i in range(micro):
            if _rows_sharded(v):
                part = v.to_local()[i * step:(i + 1) * step]
                out[i][k] = DTensor.from_local(
                    part, v.device_mesh, v.placements, run_check=False,
                    shape=(v.shape[0] // micro, *v.shape[1:]),
                    stride=part.stride())
            else:
                out[i][k] = v[i * step:(i + 1) * step]
    return out


def _rows_sharded(v) -> bool:
    return isinstance(v, DTensor) and any(
        p.is_shard(0) for p in v.placements)


def make_train_step(model: Model, opt):
    """``train_step(params, opt_state, batch)``. With
    ``runtime.MICROBATCHES`` (read when the step is made) above 1 the
    batch is split along its rows and the gradients summed in float32
    accumulators, each microbatch's gradient divided by their count, the
    loss and metrics averaged the same way, as the reference's scan."""
    loss_fn = make_loss_fn(model)
    micro = RT.MICROBATCHES

    def grads_of(params: dict, batch: dict):
        total, metrics = loss_fn(batch)
        names = list(params)
        if isinstance(total, DTensor):   # one loss on every rank
            from torch.distributed.tensor.experimental import \
                implicit_replication
            total = total.redistribute(
                total.device_mesh, [Replicate()] * total.device_mesh.ndim)
            # the plain tensors the forward made meet DTensor gradients
            with implicit_replication():
                got = torch.autograd.grad(total, [params[k] for k in names],
                                          allow_unused=True)
        else:
            got = torch.autograd.grad(total, [params[k] for k in names],
                                      allow_unused=True)
        grads = {k: _like(g, params[k]) for k, g in zip(names, got)}
        return replicated(total.detach()), \
            {k: replicated(v.detach()) for k, v in metrics.items()}, grads

    def train_step(params: dict, opt_state, batch: dict):
        if micro <= 1:
            total, metrics, grads = grads_of(params, batch)
        else:
            dev = next(iter(params.values())).device
            grads = {k: torch.zeros_like(p, dtype=F32)
                     for k, p in params.items()}
            total = torch.zeros((), dtype=F32, device=dev)
            metrics = {"loss": torch.zeros((), dtype=F32, device=dev),
                       "aux": torch.zeros((), dtype=F32, device=dev)}
            for mb in _split(batch, micro):
                t_i, m_i, g_i = grads_of(params, mb)
                for k in grads:
                    grads[k] = grads[k] + g_i[k].to(F32) / micro
                total = total + t_i / micro
                metrics = {k: metrics[k] + m_i[k] / micro for k in metrics}
        params, opt_state = opt.update(grads, opt_state, params)
        return params, opt_state, dict(metrics, total=total)
    return train_step


def _like(g, p):
    """A parameter's gradient with the parameter's placements (zero where
    the loss does not reach it)."""
    if g is None:
        return torch.zeros_like(p)
    if isinstance(g, DTensor) and g.placements != p.placements:
        g = g.redistribute(p.device_mesh, p.placements)
    return g


def make_eval_step(model: Model):
    """``eval_step(params, batch) -> metrics`` without a gradient
    (``params`` are the model's own, as the train step takes them)."""
    loss_fn = make_loss_fn(model)

    def eval_step(_params: dict, batch: dict):
        with torch.no_grad():
            _, metrics = loss_fn(batch)
        return {k: replicated(v) for k, v in metrics.items()}
    return eval_step
