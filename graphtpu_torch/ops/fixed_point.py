"""The one-WHILE fixed-point loops as device loops: ``while changed and it <
limit: step``, the shape of the JAX package's ``_sssp_kernel``,
``_wcc_kernel``, ``_cdlp_slab_kernel`` and ``_cdlp_sort_kernel``.

Each loop (sssp-impl=device, wcc-impl=device, cdlp-impl=slab and
cdlp-impl=sort) is two step functions on one nest, ``NEST``: ``init`` (the
state's first values, iteration 0 where JAX runs it before its
``while_loop``) and ``step`` (one iteration). Both issue only hand-kernel
launches, memsets and copies, and end with kernel K25
(``fixed_point_route``), which writes the loop's condition into a control
vector of ``FCTL_WORDS`` int32 words and, inside the graph, into the WHILE
node's handle. On a card the loop is one ``FixedPointGraph``
(ops/device_loop.py), launched once, with one read of the control words after
it; on the CPU, and inside ``kernels.plain_torch()``, ``device_loop.run_host``
walks the same nest: the reference the graph is held against.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from graphtpu_torch.ops import device_loop, kernels

# The control words (int32, csrc/fixed_point.cu FCTL_*): the iterations run,
# their limit, the iterations that count as changed unread (sort CDLP's
# skip_checks), the last step's any, and the WHILE's condition.
FCTL_IT, FCTL_LIMIT, FCTL_SKIP, FCTL_ANY, FCTL_COND = range(5)
FCTL_WORDS = 5
# K25's stages: the loop's first values, after a step
STAGE_INIT, STAGE_STEP = range(2)
NEST = ("init", ("while", 0, ("step",)))


class Control(NamedTuple):
    """A fixed-point loop's control: allocated once with its state."""

    ctl: torch.Tensor                # [FCTL_WORDS] int32 on the device
    params: torch.Tensor             # [2] int32 on the host, pinned on a card: (limit, skip)
    handles: Optional[torch.Tensor]  # [1] int64 conditional handle, or None


def control(device, handles: bool) -> Control:
    dev = torch.device(device)
    return Control(torch.zeros(FCTL_WORDS, dtype=torch.int32, device=dev),
                   torch.zeros(2, dtype=torch.int32, pin_memory=dev.type == "cuda"),
                   torch.zeros(1, dtype=torch.int64, device=dev) if handles else None)


def fixed_point_route_plain(fp: Control, stage: int, start: int = 0, old=None, new=None,
                            deg=None, flag=None) -> None:
    """K25's plain PyTorch version, the JAX loops' formulation: at init it =
    start, cond = it < limit; after a step any = ``flag`` != 0, or
    any(new' != old) with new' = where(deg > 0, new, old) (``deg`` None:
    new' = new) and old := new'; cond = (it < skip | any) & (it + 1 <
    limit); it += 1."""
    ctl = fp.ctl
    if stage == STAGE_INIT:
        limit, skip = (int(x) for x in fp.params)
        ctl[FCTL_IT], ctl[FCTL_LIMIT], ctl[FCTL_SKIP], ctl[FCTL_ANY] = start, limit, skip, 1
        ctl[FCTL_COND] = int(start < limit)
        return
    if new is not None:
        nv = new if deg is None else torch.where(deg > 0, new, old)
        any_ = (nv != old).any()
        old.copy_(nv)
    else:
        any_ = flag != 0
    it = ctl[FCTL_IT].clone()
    ctl[FCTL_ANY] = any_
    ctl[FCTL_COND] = ((it < ctl[FCTL_SKIP]) | any_) & (it + 1 < ctl[FCTL_LIMIT])
    ctl[FCTL_IT] = it + 1


def fixed_point_route(fp: Control, stage: int, start: int = 0, old=None, new=None, deg=None,
                      flag=None) -> None:
    """K25 wrapper, the end of a fixed-point loop's step: at ``STAGE_INIT``
    it = ``start`` (the iterations run before the WHILE), limit and skip read
    from ``fp.params`` (pinned host memory on a card, which the kernel reads)
    and the condition it < limit; after a step (``STAGE_STEP``) the step's
    any, either from ``flag`` (a 0-d int32 view of a word an earlier kernel
    wrote: nonzero when the step changed something) or by comparing ``new``
    with ``old`` (int32 [n]; where ``deg`` (int32 [n]) is 0 the old value
    stays), old := new in the same pass; then the condition (it < skip or
    any) and it + 1 < limit, and it += 1. The condition goes into
    ``fp.ctl`` and, given ``fp.handles``, into the WHILE node. One launch,
    nothing read back."""
    ctl = fp.ctl
    if ctl.dtype != torch.int32 or ctl.shape != (FCTL_WORDS,) or stage not in (STAGE_INIT,
                                                                            STAGE_STEP):
        raise TypeError(f"fixed_point_route: ctl int32 [{FCTL_WORDS}], stage {stage}")
    if stage == STAGE_STEP and (new is None) == (flag is None):
        raise ValueError("fixed_point_route: a step takes new (with old) or flag, not both")
    ts = [t for t in (old, new, deg, flag) if t is not None]
    if any(t.dtype != torch.int32 or t.device != ctl.device or not t.is_contiguous()
           for t in ts):
        raise TypeError("fixed_point_route: int32 contiguous tensors on ctl's device")
    if new is not None and (old is None or old.shape != new.shape or
                            (deg is not None and deg.shape != new.shape)):
        raise ValueError("fixed_point_route: old, new and deg of one length")
    if flag is not None and flag.numel() != 1:
        raise ValueError("fixed_point_route: flag is one word")
    if not kernels.use_kernel(ctl):
        fixed_point_route_plain(fp, stage, start, old, new, deg, flag)
        return
    if stage == STAGE_INIT and not fp.params.is_pinned():
        raise ValueError("fixed_point_route: on a card params must be pinned, the kernel reads "
                         "them")
    n = 0 if new is None else new.shape[0]
    acc = torch.empty(2, dtype=torch.int32, device=ctl.device) if n else None
    kernels.launch("fixed_point_route", ctl.device, None if old is None else old.data_ptr(),
                   None if new is None else new.data_ptr(),
                   None if deg is None else deg.data_ptr(), n,
                   None if flag is None else flag.data_ptr(),
                   None if acc is None else acc.data_ptr(), ctl.data_ptr(),
                   fp.params.data_ptr(), stage, start,
                   None if fp.handles is None else fp.handles.data_ptr(),
                   8 * kernels.sm_count(ctl.device))


def runs(ctl: list, start: int = 0) -> dict:
    """Each step's executions in a run, from the run's control words."""
    return {"init": 1, "step": ctl[FCTL_IT] - start}


class FixedPointGraph(device_loop.LoopGraph):
    """A fixed-point loop as one CUDA graph: init -> WHILE {step} -> a copy
    of ``out_src``. ``st`` is the loop's state, a NamedTuple whose ``fp``
    field is its ``Control`` (with handles); ``steps_of(st)`` gives its
    (name, step) pairs."""

    def __init__(self, st, steps_of: Callable, out_src: torch.Tensor):
        self.st = st
        eager = [step for _, step in steps_of(st._replace(fp=st.fp._replace(handles=None)))]
        super().__init__(out_src.device, steps_of(st), eager, NEST, st.fp.handles, out_src)


def launch(probe: torch.Tensor, memo: dict, key, make_state: Callable, steps_of: Callable,
           out_of: Callable, limit: int, skip: int = 0, setup: Callable | None = None,
           ranges: dict | None = None, range_name: str = "loop.graph"):
    """A fixed-point loop's run up to its last step, nothing read back on a
    card: (result, ctl, the graph or None, the host loop's reads of the
    condition). On a card (``probe``'s device, outside ``plain_torch()``)
    one launch of the graph memoized in ``memo`` under ``key`` (built from
    ``make_state(True)`` at the first run); else the host loop over a fresh
    ``make_state(False)``. ``limit`` and ``skip`` go to the control's
    params, ``setup(st)`` writes a run's other inputs (a source)."""
    if kernels.use_kernel(probe):
        loop = memo.get(key)
        if loop is None:
            st = make_state(True)
            loop = memo[key] = FixedPointGraph(st, steps_of, out_of(st))
        st = loop.st
        st.fp.params[0], st.fp.params[1] = limit, skip
        if setup is not None:
            setup(st)
        return loop.launch(range_name), st.fp.ctl, loop, 0
    st = make_state(False)
    st.fp.params[0], st.fp.params[1] = limit, skip
    if setup is not None:
        setup(st)
    reads = device_loop.run_host(NEST, dict(steps_of(st)),
                                 lambda j: bool(st.fp.ctl[FCTL_COND + j]), ranges)
    return out_of(st), st.fp.ctl, None, reads
