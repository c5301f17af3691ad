"""Pipeline parallelism (GPipe-style) over a 'stage' mesh axis (the
counterpart of ``repro.distributed.pipeline``).

Layers are grouped into S stages, stage s on the rank at index s of the
mesh's 'stage' axis. Over ``n_micro + S - 1`` clock ticks every stage runs
its block on its current microbatch: stage 0 ingests microbatch t, each
stage's output shifts one stage along a ring (the JAX ``ppermute``, here
one ``batch_isend_irecv`` a tick), and the last stage emits microbatch
t - (S - 1); bubbles at the ends compute on zeros and are dropped. A
closing masked ``all_reduce`` (the JAX masked ``psum``) gives every rank
the last stage's outputs.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.distributed.api import tree_leaves, tree_unflatten


def _ring_shift(y: torch.Tensor, group, sid: int, n_stages: int):
    """``y`` sent to stage sid + 1, the tensor of stage sid - 1 returned
    (mod S): one exchange over ``group``. A ring of one stage is the
    identity (no rank sends to itself)."""
    if n_stages == 1:
        return y
    nxt = torch.empty_like(y)
    ops = [dist.P2POp(dist.isend, y.contiguous(),
                      group=group, group_peer=(sid + 1) % n_stages),
           dist.P2POp(dist.irecv, nxt,
                      group=group, group_peer=(sid - 1) % n_stages)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return nxt


def pipeline(block_fn: Callable, mesh, n_stages: int, n_micro: int,
             stage_axis: str = "stage"):
    """Build a pipelined forward: ``run(stage_params, x_micro) -> y_micro``,
    called by every rank of the mesh.

    ``block_fn(params_slice, x) -> y`` is one stage's computation;
    ``stage_params`` a tree whose leaves have a leading dim of n_stages
    (each rank uses its stage's entry); ``x_micro`` (n_micro, mb, ...)
    microbatches, the same on every rank (only stage 0 reads them)."""
    group = mesh.get_group(stage_axis)
    if dist.get_world_size(group) != n_stages:
        raise ValueError(f"mesh axis {stage_axis!r} has "
                         f"{dist.get_world_size(group)} ranks for "
                         f"{n_stages} stages")

    def run(stage_params, xs: torch.Tensor) -> torch.Tensor:
        sid = mesh.get_local_rank(stage_axis)
        p = tree_unflatten(stage_params,
                           iter(a[sid] for a in tree_leaves(stage_params)))
        mb_shape = xs.shape[1:]
        buf = xs.new_zeros(mb_shape)                 # this stage's input
        outs = xs.new_zeros((n_micro, *mb_shape))
        for t in range(n_micro + n_stages - 1):
            # stage 0 ingests microbatch t (zeros in the drain)
            x_in = xs[t] if t < n_micro else xs.new_zeros(mb_shape)
            y = block_fn(p, x_in if sid == 0 else buf)
            buf = _ring_shift(y, group, sid, n_stages)
            out_idx = t - (n_stages - 1)
            if sid == n_stages - 1 and out_idx >= 0:
                outs[out_idx] = y
        # only the last stage holds real outputs; broadcast by masked sum
        outs = outs * float(sid == n_stages - 1)
        dist.all_reduce(outs, op=dist.ReduceOp.SUM, group=group)
        return outs

    return run


def reference_stack(block_fn: Callable, stage_params, xs: torch.Tensor):
    """Unpipelined oracle: the stages in sequence on each microbatch."""
    leaves = tree_leaves(stage_params)
    n_stages = leaves[0].shape[0]

    def one(x):
        for s in range(n_stages):
            x = block_fn(tree_unflatten(stage_params,
                                        iter(a[s] for a in leaves)), x)
        return x

    return torch.stack([one(x) for x in xs])
