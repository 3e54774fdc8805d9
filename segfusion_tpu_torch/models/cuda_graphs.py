"""CUDA graphs of an inference forward, one per input signature.

A net's forward on the card is hundreds of small kernels, each launched
from Python; replaying them from a CUDA graph costs the host one graph
launch. :class:`SignatureGraphs` keeps the graphs of one forward: the
first call at a signature runs eager, the second warms up on the capture
stream, captures and replays, later ones copy their inputs into the
graph's static inputs and replay. The result is a copy of the graph's
output, which the next replay overwrites. At most ``_GRAPHS_MAX`` (4)
signatures are kept, the least recently used dropped with its graph; a
change in the storage the forward reads (its weights' addresses) drops
every graph. Counters and spans (``utils/tracing``), for a forward named
``x``: ``x.eager``, ``x.captures``, ``x.replays``; ``x.capture``,
``x.replay``.

Used by ``models/fusionnet_fast.py`` (``FastV3``, named ``fusionnet``)
and ``models/adapnet.py`` (``SegmenterAdapter``, named ``adapnet``);
each decides itself when a call may take a graph (`_on_card` and
its own mode).
"""

from __future__ import annotations

import collections
from typing import Callable, Dict, Hashable, Tuple

import torch

from ..utils import tracing

__all__ = ["SignatureGraphs"]

# the input signatures (and their graphs) one forward keeps
_GRAPHS_MAX = 4
_SEEN = object()        # a signature met once: its call ran eager
# one capture stream per card index, reused by every capture on it
_CAPTURE_STREAMS: Dict[int, "torch.cuda.Stream"] = {}

Inputs = Dict[str, torch.Tensor]


def _on_card(inputs: Inputs) -> bool:
    """Every input a CUDA tensor, and the current stream not already
    capturing a graph."""
    return (all(t.is_cuda for t in inputs.values())
            and not torch.cuda.is_current_stream_capturing())


def _capture(fn: Callable[[], torch.Tensor], device: torch.device
             ) -> Tuple[Callable[[], None], torch.Tensor]:
    """``fn`` warmed up on ``device``'s capture stream, then captured
    into a CUDA graph there. Returns the graph's replay and ``fn``'s
    output, which each replay rewrites in place (on the current
    stream)."""
    with torch.cuda.device(device):
        stream = _CAPTURE_STREAMS.get(device.index)
        if stream is None:
            stream = _CAPTURE_STREAMS[device.index] = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            fn()
        torch.cuda.current_stream().wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream,
                              capture_error_mode="thread_local"):
            out = fn()
    return graph.replay, out


class SignatureGraphs(collections.OrderedDict):
    """signature -> ``_SEEN`` or (static inputs, replay, static output),
    least recently used first, for the forward called ``name``."""

    def __init__(self, name: str):
        super().__init__()
        self.ptrs = None        # the storage the graphs read
        self._names = tuple(f"{name}.{s}" for s in
                            ("eager", "capture", "captures", "replay",
                             "replays"))

    def __call__(self, key: Hashable, ptrs: Tuple[int, ...], inputs: Inputs,
                 fn: Callable[[Inputs], torch.Tensor],
                 capture_fn: Callable) -> torch.Tensor:
        """``fn(inputs)``, eager or from the graph of signature ``key``;
        ``ptrs``: the addresses of the storage ``fn`` reads besides its
        inputs; ``capture_fn``: ``_capture`` (a test's stand-in where it
        replaces the caller's)."""
        eager, capturing, captures, replaying, replays = self._names
        if ptrs != self.ptrs:
            self.clear()
            self.ptrs = ptrs
        graph = self.get(key)
        if graph is None:
            self[key] = _SEEN
            while len(self) > _GRAPHS_MAX:
                self.popitem(last=False)
            tracing.count(eager)
            return fn(inputs)
        self.move_to_end(key)
        if graph is _SEEN:
            with tracing.span(capturing):
                static = {k: t.clone() for k, t in inputs.items()}
                replay, out = capture_fn(lambda: fn(static),
                                         next(iter(static.values())).device)
            self[key] = graph = (static, replay, out)
            tracing.count(captures)
        static, replay, out = graph
        with tracing.span(replaying):
            for k, t in inputs.items():
                static[k].copy_(t)
            replay()
            result = out.clone()
        tracing.count(replays)
        return result
