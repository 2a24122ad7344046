"""The plain reference of each configuration's training step.

Plain PyTorch in float32, written from the published architectures and
from the optimizers' update rules, with no kernel, cache or layout trick.
It imports nothing of the program under test and takes nothing the
program made: the benchmark hands it the same seeded weights and batches
it handed the program.  The caller turns TF32 off before running it.

``precision`` rounds the operands of every matrix product and convolution
(``quant.rounder``): ``"float32"`` is the reference itself, the lower ones
make the control that the comparison has to catch.
"""

from __future__ import annotations

import torch

__all__ = ["train_readings", "norms"]


def norms(tensors):
    """``{path: L2 norm}`` of a dict of tensors, as Python floats."""
    keys = sorted(tensors)
    if not keys:
        return {}
    vals = torch.stack([torch.linalg.vector_norm(tensors[k].float())
                        for k in keys]).tolist()
    return dict(zip(keys, vals))


def train_readings(loss_and_grads, params0, shard_batches, optimizer,
                   steps=3):
    """Run ``steps`` data-parallel training steps from ``params0`` and
    return what the check compares: each step's loss, the per-leaf norms
    of the first step's gradient, and the per-leaf norms of the change of
    the parameters after the last step.

    ``loss_and_grads(params, batch) -> (mean loss, {path: gradient})`` is
    one rank's forward and backward on its batch.  ``shard_batches[i]``
    lists step ``i``'s batch of each rank; the step's gradient is the mean
    of the ranks', its loss the mean of theirs.  ``optimizer`` is an
    ``optim`` rule; ``params0`` is left as it is.
    """
    params = {k: v.detach().clone().float() for k, v in params0.items()}
    state = optimizer.init(params)
    losses, first = [], None
    for i in range(steps):
        loss_sum, grad_sum = 0.0, None
        for batch in shard_batches[i]:
            loss, grads = loss_and_grads(params, batch)
            loss_sum += float(loss)
            if grad_sum is None:
                grad_sum = grads
            else:
                for k in grad_sum:
                    grad_sum[k] += grads[k]
        n = len(shard_batches[i])
        grads = {k: g / n for k, g in grad_sum.items()}
        losses.append(loss_sum / n)
        if first is None:
            first = norms(grads)
        optimizer.step(params, grads, state)
        del grads, grad_sum
    change = norms({k: params[k] - params0[k].float() for k in params})
    return {"loss": losses, "grad1": first, "change": change}
