"""The general generator of the training traffic.

A traffic file (``workloads/<name>.json``) is parameters only:

* ``kind``: ``images`` (uint8 images of the configuration's size and
  integer labels below its class count) or ``tokens`` (rows of
  ``seq_len + 1`` token ids below its vocabulary: the first ``seq_len``
  are the input, the last ``seq_len`` the next-token targets);
* ``examples``: how many, drawn once per run from the seed on the device
  in one call each and kept in host memory;
* ``ranks``: the processes (one card each) the job runs on; each takes
  the contiguous ``examples / ranks`` of them that ChainerMN's
  ``scatter_dataset`` gives it, and walks them in order;
* ``batch_per_rank``: each rank's batch a step;
* ``prefetch``: the device feed's depth;
* ``check_steps``: the steps the check follows from the seed.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["make", "rank_batch"]

_MASK = (1 << 63) - 1


def generator(seed, stream, device):
    """A generator on ``device`` for one stream of the run's draws."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1000003 + stream) & _MASK)
    return g


def make(cfg, traffic, seed, device):
    """The run's examples as host arrays ``(inputs, targets)``."""
    n, kind = traffic["examples"], traffic["kind"]
    if n % traffic["ranks"]:
        raise ValueError(f"{n} examples do not split over "
                         f"{traffic['ranks']} ranks")
    g = generator(seed, 1, device)
    if kind == "images":
        s, c = cfg["image_size"], cfg["channels"]
        x = torch.randint(0, 256, (n, s, s, c), dtype=torch.uint8,
                          generator=g, device=device)
        if cfg["layout"] == "NCHW":
            x = x.permute(0, 3, 1, 2).contiguous()
        t = torch.randint(0, cfg["n_classes"], (n,), generator=g,
                          device=device).to(torch.int32)
        return x.cpu().numpy(), t.cpu().numpy()
    if kind == "tokens":
        T = traffic["seq_len"]
        if T > cfg["n_positions"]:
            raise ValueError(f"seq_len {T} exceeds the model's "
                             f"{cfg['n_positions']} positions")
        rows = torch.randint(0, cfg["vocab_size"], (n, T + 1),
                             generator=g, device=device).cpu().numpy()
        return (np.ascontiguousarray(rows[:, :-1]),
                np.ascontiguousarray(rows[:, 1:]))
    raise ValueError(f"unknown traffic kind {kind!r}")


def rank_batch(examples, traffic, rank, step, device):
    """Rank ``rank``'s batch of step ``step`` (0-based), as tensors on
    ``device``: its shard's rows in order, wrapping at the shard's end."""
    per = traffic["examples"] // traffic["ranks"]
    B = traffic["batch_per_rank"]
    idx = (np.arange(step * B, (step + 1) * B) % per) + rank * per
    return tuple(torch.from_numpy(a[idx]).to(device) for a in examples)
