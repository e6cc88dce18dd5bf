"""CUDA graphs of the port's rounds: one shared memory pool a card, the
capture with its warm-up, a round's `Body`, and a small cache of captured
graph sets keyed by configuration, blocks a round and card. The CDL and
block-fading pipelines build their round sets from these.
"""
from __future__ import annotations

import collections
import dataclasses
import os
import time
import traceback

import torch

from ..config import SimConfig


class GraphCaptureError(RuntimeError):
    """A CUDA graph capture failed; the message names the port's line that
    broke it. Deterministic, so never retried."""


# The memory pool every CUDA graph of the port captures into, one a card:
# the graphs replay one after another on one stream, and each reads and
# writes only buffers made outside any capture, so their temporaries may
# share memory. card -> [pool handle, graphs alive in it]: PyTorch frees a
# pool once its last graph is reset, and a handle of a freed pool cannot
# take another capture, so the entry goes with its last graph.
_POOLS: dict = {}


def capture_graph(body, what: str, dev: torch.device):
    """Run `body()` once eagerly on a side stream (the warm-up: nvcc builds,
    cuFFT plans, codes' host construction, the kernels' attribute and
    occupancy queries, device constants), then capture one call of it as a
    CUDA graph in the card's shared pool. Returns (graph, the capture's
    host ms, bytes the pool grew by). Raises GraphCaptureError where the
    capture fails, naming the port's line that broke it."""
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        body()
    torch.cuda.current_stream(dev).wait_stream(side)
    if dev not in _POOLS:
        _POOLS[dev] = [torch.cuda.graph_pool_handle(), 0]
    pool = _POOLS[dev]
    graph = torch.cuda.CUDAGraph()
    t0 = time.perf_counter()
    try:
        with torch.cuda.graph(graph, pool=pool[0]):
            # after the capture's own empty_cache: what the body reserves
            # from here on is the pool's growth
            reserved = torch.cuda.memory_reserved(dev)
            body()
            pool_bytes = torch.cuda.memory_reserved(dev) - reserved
    except Exception as e:
        if not pool[1]:
            del _POOLS[dev]
        here = [f for f in traceback.extract_tb(e.__traceback__)
                if f"{os.sep}esn_ofdm_mimo_tpu_torch{os.sep}" in f.filename]
        at = (f"{here[-1].filename}:{here[-1].lineno} ({here[-1].line})"
              if here else "outside the package")
        raise GraphCaptureError(f"CUDA graph capture of {what} failed at "
                                f"{at}: {e}") from e
    pool[1] += 1
    return graph, 1e3 * (time.perf_counter() - t0), pool_bytes


def _release_graph(graph, dev: torch.device):
    """Reset a graph of `capture_graph`; its card's pool entry goes with
    the last one."""
    graph.reset()
    _POOLS[dev][1] -= 1
    if not _POOLS[dev][1]:
        del _POOLS[dev]


def _card(dev: torch.device) -> torch.device:
    """`dev` with its index: "cuda" names the current card."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def graph_pool_bytes(dev: torch.device) -> int:
    """Device memory of the card's shared graph pool: its segments in the
    caching allocator's snapshot."""
    pool = _POOLS.get(_card(dev))
    if pool is None:
        return 0
    return sum(seg["total_size"]
               for seg in torch.cuda.memory._snapshot()["segments"]
               if tuple(seg.get("segment_pool_id", ())) == tuple(pool[0]))


class Body:
    """One body of a round: a function that reads and writes only buffers
    made before it. On the card it is captured once as a CUDA graph and
    `run` replays it; on the CPU `run` calls the function."""

    def __init__(self, fn, what: str, dev: torch.device):
        self.fn, self.graph, self.dev = fn, None, dev
        self.capture_ms, self.pool_bytes = 0.0, 0
        if dev.type == "cuda":
            self.graph, self.capture_ms, self.pool_bytes = capture_graph(
                fn, what, dev)

    def run(self):
        if self.graph is None:
            self.fn()
        else:
            self.graph.replay()

    def release(self):
        if self.graph is not None:
            _release_graph(self.graph, self.dev)
            self.graph = None


# Captured graph sets (a calibration chunk, a CDL round set), the least
# recently used released first past _CACHE_SIZE; `release_graphs` releases
# them all
_CACHE: "collections.OrderedDict[tuple, object]" = collections.OrderedDict()
_CACHE_SIZE = 4


def graph_key(cfg: SimConfig, G: int, dev: torch.device, kind: str) -> tuple:
    """The cache key of a graph set: (kind, cfg without its Eb/N0 grid,
    which the bodies read from their row buffer, blocks a round, card, the
    predict switch ESN_TPU_PREDICT_READOUT, which picks K2 or K4). A set
    is made from its key's cfg and card."""
    return (kind, dataclasses.replace(cfg, ebno_db=()), int(G), _card(dev),
            os.environ.get("ESN_TPU_PREDICT_READOUT"))


def cached_graphs(key: tuple, make):
    """The graph set of `key`, made by `make()` on first use."""
    if key in _CACHE:
        _CACHE.move_to_end(key)
        return _CACHE[key]
    while len(_CACHE) >= _CACHE_SIZE:
        _CACHE.popitem(last=False)[1].release()
    if key[3].type == "cuda":
        with torch.cuda.device(key[3]):
            _CACHE[key] = make()
    else:
        _CACHE[key] = make()
    return _CACHE[key]


def release_graphs():
    """Release every cached graph set: its graphs and their memory."""
    while _CACHE:
        _CACHE.popitem()[1].release()
