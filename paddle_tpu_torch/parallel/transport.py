"""The exchange between the processes of a mesh.

A mesh over several processes (``distributed.launch.global_mesh``) reaches
the positions of other processes through one ``Transport``: point-to-point
messages over the ``torch.distributed`` group, posted together with
``batch_isend_irecv``.  ``distributed.launch.init_distributed`` chooses
its backend by one rule before the group is joined: ``nccl`` where every
rank holds a card of its own, else ``gloo``, with each card tensor staged
through a pinned host buffer (NCCL does not admit two ranks on one card;
a CPU tensor is sent as it is).  A message carries the tensors for one
peer packed into one byte buffer; both sides know every tensor's shape
and dtype from the plan of the collective, so nothing else is sent.

``exchange`` is differentiable by construction: under grad mode it is a
``torch.autograd.Function`` whose backward is the transposed exchange
(each received tensor's gradient goes back to its sender, each sent
tensor's gradient comes back from its receivers).  Every process runs the
same collectives in the same order, so the exchanges' backwards run in
the same (reverse) order too.  Each one also returns a zero-dim token
tied to the transport's anchor (a leaf): ``grad`` adds the tokens as
roots and the anchor as an input, so the backward of an exchange runs on
every process even where that process received nothing its loss reads (a
pipeline's first stage, whose hop only sends).

``Transport.tally`` is a plain per-process count of the exchanges, the
bytes sent and received and the wall seconds they took.
"""

from __future__ import annotations

import time
from typing import Dict, List, Sequence, Tuple

import torch

_ALIGN = 16  # byte offset of each tensor in a packed message

def _nbytes(shape, dtype) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n * torch.empty((), dtype=dtype).element_size()


def _padded(n: int) -> int:
    return (n + _ALIGN - 1) // _ALIGN * _ALIGN


def _message_bytes(sizes) -> int:
    """A message's length: the padded tensors, never empty."""
    return max(sum(_padded(n) for n in sizes), _ALIGN)


class Transport:
    """The exchange of one process with the others of its group.

    `backend` is ``"gloo"`` or ``"nccl"``; `staged` says that card tensors
    go through pinned host buffers (gloo); `reason` is the rule's words;
    `device` is this process's card (or the CPU)."""

    def __init__(self, rank: int, world: int, backend: str, staged: bool,
                 reason: str, device: torch.device):
        self.rank = int(rank)
        self.world = int(world)
        self.backend = backend
        self.staged = bool(staged)
        self.reason = reason
        self.device = torch.device(device)
        self.tally = {"exchanges": 0, "bytes_sent": 0, "bytes_received": 0,
                      "seconds": 0.0}
        self._seq = 0
        # collectives whose plan crossed a process boundary (the same count
        # on every process)
        self.crossings = 0
        # the tokens of the differentiable exchanges since the last
        # ``grad`` or ``backward``, and the leaf they hang from
        self._tokens: list = []
        self._anchor = None

    def __repr__(self):
        return (f"Transport(rank {self.rank} of {self.world}, "
                f"{self.backend}{', staged' if self.staged else ''})")

    def reset_tally(self):
        for k in self.tally:
            self.tally[k] = 0.0 if k == "seconds" else 0

    def next_tag(self) -> int:
        """A tag for the next collective: every process calls every
        collective, so the counters agree (the backward uses tag + 1)."""
        self._seq += 1
        return (2 * self._seq) % (1 << 30)

    # -- the wire ------------------------------------------------------
    def _pack(self, tensors: Sequence[torch.Tensor]) -> torch.Tensor:
        sizes = [_padded(t.numel() * t.element_size()) for t in tensors]
        dev = tensors[0].device
        on_host = dev.type == "cpu" or self.staged
        buf = torch.empty(max(sum(sizes), _ALIGN), dtype=torch.uint8,
                          device="cpu" if on_host else dev,
                          pin_memory=on_host and dev.type == "cuda")
        off = 0
        for t, n in zip(tensors, sizes):
            raw = t.detach().contiguous().reshape(-1).view(torch.uint8)
            buf[off:off + raw.numel()].copy_(raw, non_blocking=True)
            off += n
        if on_host and dev.type == "cuda":
            torch.cuda.current_stream(dev).synchronize()
        return buf

    def _unpack(self, buf, specs) -> List[torch.Tensor]:
        out, off = [], 0
        for shape, dtype, device in specs:
            n = _nbytes(shape, dtype)
            t = buf[off:off + n].view(dtype).reshape(shape)
            if torch.device(device) != buf.device:
                t = t.to(device, non_blocking=True)
            out.append(t)
            off += _padded(n)
        return out

    def xfer(self, sends: Dict[int, List[torch.Tensor]],
             recvs: Dict[int, List[Tuple[tuple, torch.dtype, object]]],
             tag: int) -> Dict[int, List[torch.Tensor]]:
        """Send `sends[peer]` to each peer and receive `recvs[peer]`
        (shape, dtype, device each) from each, all posted at once; returns
        {peer: received tensors}.  A failed send or receive raises."""
        import torch.distributed as dist

        t0 = time.perf_counter()
        ops, inbox = [], {}
        kw = {"tag": tag} if self.backend == "gloo" else {}
        for peer in sorted(set(sends) | set(recvs)):
            if sends.get(peer):
                buf = self._pack(sends[peer])
                self.tally["bytes_sent"] += buf.numel()
                ops.append(dist.P2POp(dist.isend, buf, peer, **kw))
            if recvs.get(peer):
                n = _message_bytes(_nbytes(s, d) for s, d, _ in recvs[peer])
                dev = torch.device(recvs[peer][0][2])
                on_host = dev.type == "cpu" or self.staged
                buf = torch.empty(n, dtype=torch.uint8,
                                  device="cpu" if on_host else dev,
                                  pin_memory=on_host and dev.type == "cuda")
                inbox[peer] = buf
                self.tally["bytes_received"] += n
                ops.append(dist.P2POp(dist.irecv, buf, peer, **kw))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        out = {peer: self._unpack(buf, recvs[peer])
               for peer, buf in inbox.items()}
        self.tally["exchanges"] += 1
        self.tally["seconds"] += time.perf_counter() - t0
        return out

    # -- the differentiable exchange -------------------------------------
    def exchange(self, sends: Dict[int, List[torch.Tensor]],
                 recvs: Dict[int, List[tuple]], tag: int
                 ) -> Dict[int, List[torch.Tensor]]:
        """``xfer``, differentiable under grad mode (the backward is the
        transposed exchange, on tag + 1)."""
        if not torch.is_grad_enabled():
            return self.xfer(sends, recvs, tag)
        send_peers = [(p, len(ts)) for p, ts in sorted(sends.items()) if ts]
        recv_peers = [(p, list(specs)) for p, specs in sorted(recvs.items())
                      if specs]
        flat = [t for p, _ in send_peers for t in sends[p]]
        if self._anchor is None:
            self._anchor = torch.zeros((), device=self.device,
                                       requires_grad=True)
        token, *got = _Exchange.apply(self, tag, send_peers, recv_peers,
                                      self._anchor, *flat)
        self._tokens.append(token)
        out, i = {}, 0
        for p, specs in recv_peers:
            out[p] = got[i:i + len(specs)]
            i += len(specs)
        return out


def _floating(dtype) -> bool:
    return dtype.is_floating_point or dtype.is_complex


class _Exchange(torch.autograd.Function):
    """forward: (token, *received); backward: the gradients of the
    received tensors sent back to their senders, those of the sent ones
    received from their receivers (floating tensors only: both sides know
    which from the dtypes)."""

    @staticmethod
    def forward(ctx, tr, tag, send_peers, recv_peers, anchor, *flat):
        sends, i = {}, 0
        for p, n in send_peers:
            sends[p] = list(flat[i:i + n])
            i += n
        got = tr.xfer(sends, dict(recv_peers), tag)
        ctx.tr, ctx.tag = tr, tag
        ctx.send_meta = [(p, [(tuple(t.shape), t.dtype, t.device)
                              for t in sends[p]]) for p, _ in send_peers]
        ctx.recv_peers = recv_peers
        received = [t for p, _ in recv_peers for t in got[p]]
        ctx.mark_non_differentiable(*[t for t in received
                                      if not _floating(t.dtype)])
        return (anchor.detach().new_zeros(()), *received)

    @staticmethod
    def backward(ctx, _dtoken, *drecv):
        tr = ctx.tr
        sends, i = {}, 0
        for p, specs in ctx.recv_peers:
            part = [g if g is not None else torch.zeros(
                s, dtype=d, device=dev)
                for g, (s, d, dev) in zip(drecv[i:i + len(specs)], specs)]
            sends[p] = [g for g, (_, d, _) in zip(part, specs)
                        if _floating(d)]
            i += len(specs)
        recvs = {p: [m for m in metas if _floating(m[1])]
                 for p, metas in ctx.send_meta}
        got = tr.xfer({p: v for p, v in sends.items() if v},
                      {p: v for p, v in recvs.items() if v}, ctx.tag + 1)
        grads = []
        for p, metas in ctx.send_meta:
            it = iter(got.get(p, []))
            grads += [next(it) if _floating(d) else None
                      for _, d, _ in metas]
        return (None, None, None, None, None, *grads)


def mark(tr) -> int:
    """Where `tr`'s token list stands before a forward whose backward
    ``grad`` or ``backward`` will run (0 without a transport)."""
    return len(tr._tokens) if tr is not None else 0


def _roots(tr, outputs, grad_outputs, since):
    """The outputs that require grad here, with `tr`'s tokens made since
    `since` (zero cotangents); the older tokens are dropped."""
    toks = []
    if tr is not None:
        toks = tr._tokens[since:]
        del tr._tokens[:]
    pairs = [(o, g) for o, g in zip(outputs, grad_outputs)
             if o.requires_grad] + [(t, torch.zeros_like(t)) for t in toks]
    return [o for o, _ in pairs], [g for _, g in pairs], bool(toks)


def grad(tr, outputs, inputs, grad_outputs, since: int = 0):
    """``torch.autograd.grad`` (unused inputs give None) with the tokens
    of `tr`'s exchanges made since `since` added as roots and its anchor
    as an input, so that every exchange's backward runs on every process.
    An output that does not require grad here is left out: its process
    may still owe its peers a backward."""
    inputs = list(inputs)
    outs, cts, linked = _roots(tr, outputs, grad_outputs, since)
    if not outs:
        return [None] * len(inputs)
    extra = [tr._anchor] if linked else []
    got = torch.autograd.grad(outs, inputs + extra, cts, allow_unused=True)
    return list(got[:len(inputs)])


def backward(tr, outputs, grad_outputs, since: int = 0):
    """``torch.autograd.backward`` with `tr`'s exchange tokens as roots
    (the leaves, its anchor included, accumulate ``.grad``)."""
    outs, cts, _ = _roots(tr, outputs, grad_outputs, since)
    if outs:
        torch.autograd.backward(outs, cts)
