"""Device-side control flow for the fused loop's CUDA graphs.

The JAX package keeps its LM loop and its CG on the device as
``lax.while_loop``s: a loop's stop is a device value and the host reads
nothing until the loop has ended. The port gets the same from two pieces:

- :func:`run_if`, one conditional, and :func:`run_while`, one loop. Under
  CUDA-graph capture a body is recorded into a conditional IF or WHILE
  node, which the device takes, skips or repeats at every replay by the
  value of its predicate; on CPU tensors, and on the card outside a
  capture, they are ``if bool(pred):`` and ``while bool(cond()):``, one
  host read each time. One code path runs both ways. Bodies nest. The
  nodes come from the CUDA runtime
  through ``csrc/graph_conditional.cu`` (a plain C interface built with
  nvcc at first use, as the kernels are): a body is captured on a stream
  of its own per nesting depth into the node's body graph, and its
  allocations go to a memory pool that lives as long as the graph.
- :class:`CapturedGraph`, one function captured once and replayed. A loop
  is its body under ``run_if(running)``, replayed as many times as the
  budget allows: a replay after the stop is a skipped node.

A conditional body changes state only by writing into tensors that exist
before it (``copy_``): a tensor it allocates is written only when the body
runs.

Launch accounting. A kernel wrapper counts its launches through
:func:`launched`. Outside a :class:`CapturedGraph` capture a launch is
credited at once. Inside one it is recorded with the conditional region it
was captured in (the graph itself or the innermost conditional body),
and each such region counts its own runs on the device (one int64 add when
it runs; a WHILE body once per trip). :meth:`CapturedGraph.launch_counts` is that vector;
:meth:`CapturedGraph.credit` takes its host copy, read by the caller with
its other results, and credits every captured launch once for each run of
its region since the last credit. So the counters say what the device
launched, as they do for a loop run eagerly.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import gc
from typing import Callable, List, Optional

import torch

from ceres_tpu_torch.ops import cuda_build


class _Region:
    """A graph or conditional body being captured: the launches captured
    directly in it, and the device counter of its runs."""

    __slots__ = ("launches", "slot")

    def __init__(self):
        self.launches: list = []  # (credit, key) per captured launch
        self.slot: Optional[int] = None  # its counter in the capture's bank


# The regions of the CapturedGraph being captured, innermost last (empty
# outside such a capture), and every region that capture opened.
_open: List[_Region] = []
_opened: List[_Region] = []
_uncounted = 0
# [counter bank, next slot] of the capture under way
_bank = None
# Conditional bodies open in the capture under way, and the body stream of
# each nesting depth per device.
_depth = 0
_body_streams: dict = {}


@functools.cache
def _library():
    lib = cuda_build.load_library("graph_conditional", ["graph_conditional.cu"])
    lib.ctt_graph_begin_conditional.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_ulonglong),
    ]
    lib.ctt_graph_set_condition.argtypes = [ctypes.c_void_p, ctypes.c_ulonglong, ctypes.c_void_p]
    lib.ctt_graph_end_conditional.argtypes = [ctypes.c_void_p]
    lib.ctt_graph_stream_create.argtypes = [ctypes.POINTER(ctypes.c_void_p)]
    for fn in (lib.ctt_graph_begin_conditional, lib.ctt_graph_set_condition,
               lib.ctt_graph_end_conditional, lib.ctt_graph_stream_create):
        fn.restype = ctypes.c_int
    return lib


def build_library() -> None:
    """Compile and load the conditional-node binding now (otherwise at first
    use)."""
    _library()


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed: cudaError {err}")


def _body_stream(device: torch.device, depth: int) -> torch.cuda.ExternalStream:
    key = (device.index, depth)
    stream = _body_streams.get(key)
    if stream is None:
        handle = ctypes.c_void_p()
        with torch.cuda.device(device):
            _check(_library().ctt_graph_stream_create(ctypes.byref(handle)), "stream creation")
        stream = _body_streams[key] = torch.cuda.ExternalStream(handle.value, device)
    return stream


def _capturing(t: torch.Tensor) -> bool:
    """Whether work on ``t``'s device is being captured into a CUDA graph."""
    return t.is_cuda and torch.cuda.is_current_stream_capturing()


def _close(region: _Region) -> None:
    """Give a region that holds launches the next counter of the capture's
    bank, and capture its increment at the region's end (a bank too small
    for the capture counts into its last slot: CapturedGraph then captures
    again with a larger one)."""
    if region.launches:
        bank, region.slot = _bank
        _bank[1] += 1
        bank[min(region.slot, bank.numel() - 1)].add_(1)


@contextlib.contextmanager
def _conditional_body(pred: torch.Tensor, loop: bool):
    """Capture the with-body into an IF (``loop`` False) or WHILE node on
    ``pred``; yields the node's handle and body stream."""
    global _depth
    lib = _library()
    pred = pred.to(torch.bool)
    parent = torch.cuda.current_stream(pred.device)
    body = _body_stream(pred.device, _depth)
    handle = ctypes.c_ulonglong()
    _check(lib.ctt_graph_begin_conditional(parent.cuda_stream, body.cuda_stream,
                                           pred.data_ptr(), int(loop), ctypes.byref(handle)),
           "capture of a conditional node")
    region = None
    if _open:
        region = _Region()
        _open.append(region)
        _opened.append(region)
    _depth += 1
    try:
        with torch.cuda.stream(body):
            yield handle.value, body
            if region is not None:
                _close(region)
    finally:
        _depth -= 1
        if region is not None:
            _open.pop()
        _check(lib.ctt_graph_end_conditional(body.cuda_stream), "end of a conditional node")


@contextlib.contextmanager
def run_if(pred: torch.Tensor):
    """The with-body runs only where the 0-dim bool tensor ``pred`` is true::

        with run_if(pred) as taken:
            if taken:
                ...

    Under capture ``taken`` is True and the body is recorded into an IF
    node that the device decides at each replay; otherwise ``taken`` is
    ``bool(pred)``."""
    if not _capturing(pred):
        yield bool(pred)
        return
    with _conditional_body(pred, loop=False):
        yield True


def run_while(cond: Callable[[], torch.Tensor], body: Callable[[], None]) -> None:
    """``while cond(): body()``, ``cond()`` a 0-dim bool tensor. Under
    capture one WHILE node: ``body`` is captured once and the device runs
    it as long as ``cond()``, evaluated before the node and at the end of
    each run, is true. Otherwise a Python loop reading ``cond()`` each
    trip."""
    pred = cond()
    if not _capturing(pred):
        while bool(pred):
            body()
            pred = cond()
        return
    with _conditional_body(pred, loop=True) as (handle, stream):
        body()
        again = cond().to(torch.bool)
        _check(_library().ctt_graph_set_condition(stream.cuda_stream, handle, again.data_ptr()),
               "a WHILE node's condition")


def launched(credit: Callable[..., None], *key) -> None:
    """Count one kernel launch: ``credit(n, *key)`` adds n launches to the
    wrapper's counters (see the module's docstring)."""
    if _uncounted:
        return
    if _open and torch.cuda.is_current_stream_capturing():
        _open[-1].launches.append((credit, key))
    else:
        credit(1, *key)


@contextlib.contextmanager
def uncounted():
    """Launches made in the body are counted nowhere: the warm-up run a
    capture needs is set-up, not a run of the loop."""
    global _uncounted
    _uncounted += 1
    try:
        yield
    finally:
        _uncounted -= 1


class CapturedGraph:
    """``fn()`` captured once into a CUDA graph on ``device``; every
    tensor ``fn`` reads or writes across replays must outlive the graph.
    The caller runs ``fn`` once eagerly before (library handles, kernel
    builds, lazy caches). A failed capture raises. With ``share``, a graph
    that never runs at the same time as this one and keeps no tensor of its
    capture alive, this graph allocates from ``share``'s pools and reuses
    its temporaries' memory; the allocator reuses a block only on the
    stream that allocated it, so the two capture their work on the same
    stream (in a conditional body of the same depth) to share it."""

    # Run counters allocated before a capture: a tensor allocated during one
    # may share memory with the graph's temporaries of an earlier point of
    # the same replay, so nothing that must outlive a replay is. A capture
    # with more counted regions is made again with a bank that holds them.
    BANK = 1024

    def __init__(self, fn: Callable[[], None], device: torch.device,
                 share: Optional["CapturedGraph"] = None):
        if _open:
            raise RuntimeError("CapturedGraph captures do not nest")
        _library()
        device = torch.device(device)
        # the memory pool takes a device with its index: "cuda" is the
        # current card
        self.device = device if device.index is not None else torch.device(
            "cuda", torch.cuda.current_device())
        # The bodies' allocations (on the body streams, which the graph's
        # private pool does not take) go to a pool of their own that lives
        # as long as the graph, as the graph's pool does.
        self.pool = torch.cuda.MemPool() if share is None else share.pool
        self._graph_pool = None if share is None else share.graph.pool()
        self.launches = 0  # kernel launches credited from this graph's replays
        size = self.BANK
        while True:
            self._bank = torch.zeros((size,), dtype=torch.int64, device=device)
            regions = self._capture(fn)
            if len(regions) <= size:
                break
            size = len(regions)
        self._regions = regions
        self._credited = [0] * len(regions)

    def _capture(self, fn) -> List[_Region]:
        """Capture ``fn``; returns the counted regions, in bank order."""
        global _bank
        self.graph = torch.cuda.CUDAGraph()
        root = _Region()
        _open.append(root)
        _opened.clear()
        _opened.append(root)
        _bank = [self._bank, 0]
        self.conditional = False  # whether a conditional body was captured
        # No collection during the capture: freeing another graph (a
        # dropped program's) while a stream captures is an error.
        collecting = gc.isenabled()
        gc.collect()
        gc.disable()
        try:
            with torch.cuda.graph(self.graph, pool=self._graph_pool):
                with torch.cuda.use_mem_pool(self.pool, self.device):
                    fn()
                    _close(root)
        finally:
            if collecting:
                gc.enable()
            _open.clear()
            self.conditional = len(_opened) > 1
            regions, _opened[:] = list(_opened), []
            _bank = None
        return sorted((r for r in regions if r.slot is not None), key=lambda r: r.slot)

    def replay(self) -> None:
        self.graph.replay()

    def credit_replay(self) -> None:
        """Credit one replay's launches on the host, with no read: for a
        graph that captured no conditional node, whose every launch runs
        once per replay."""
        if self.conditional:
            raise RuntimeError("a graph with conditional nodes counts its runs on the device")
        self.credit([n + 1 for n in self._credited])

    def launch_counts(self) -> torch.Tensor:
        """(regions,) int64 device tensor: each counted region's runs."""
        return self._bank[: len(self._regions)]

    def credit(self, counts) -> None:
        """Credit the captured launches for the runs in ``counts`` (a host
        copy of :meth:`launch_counts`) since the last credit."""
        for i, (region, n) in enumerate(zip(self._regions, counts)):
            runs = int(n) - self._credited[i]
            self._credited[i] = int(n)
            if runs:
                for credit, key in region.launches:
                    credit(runs, *key)
                self.launches += runs * len(region.launches)


def pool_bytes(graphs) -> int:
    """Device bytes held by the memory pools of ``graphs`` (their private
    pools and their bodies' pools, each pool once): memory that stays
    reserved for as long as the graphs."""
    pools = {tuple(p) for g in graphs for p in (g.graph.pool(), g.pool.id)}
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg["segment_pool_id"]) in pools)
