"""Abstract execution: the dry run's tensors that hold no data.

The multi-pod dry run (``repro_torch.launch.dryrun``) runs one rank's
eager step on fake tensors (``torch._subclasses.fake_tensor``) over
torch's ``fake`` process group: every operation computes its result's
shape and dtype and nothing else, so nothing is allocated and nothing is
computed.  This module is what the port's code consults where a real run
would need the data, and what the kernel wrappers credit their work to.

* :func:`tracing` opens a :class:`Run`.  ``card=True`` traces the card's
  path: a kernel wrapper given fake operands (:func:`on_card`) returns
  fake outputs of its kernel's shapes and dtypes and credits the kernel's
  bytes and operations (the arithmetic of its bound) to the run, instead
  of building or launching anything; prefill attention takes the flash
  kernel.  The fake tensors themselves lie on the host: PyTorch built
  without CUDA cannot index, or record autograd on, a fake ``cuda``
  tensor, and the card's path is chosen by :func:`on_card`, not by the
  tensors' device.
* Where a real run reads device data on the host, a fake tensor gives the
  static figure that XLA's static buffers take: the plan's capacity-sized
  payload.  An escape stream fits its capacity (:func:`host_bool` is
  True), every escape slot is in use (:func:`used_slots`,
  :func:`fill_used_slots` and :func:`n_used_slots`, the one place that
  figure is decided for the codec and the transport), and a message header
  is the one its sender posted (:meth:`Run.post` / :meth:`Run.collect`).

Outside a run, or on a real tensor, every helper is the plain host read,
and no wrapper takes its abstract form: a real CUDA tensor still launches
its kernel or raises.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
from typing import Deque, Dict, List, Optional

import torch


def is_fake(t) -> bool:
    """True for a fake tensor (no data behind it)."""
    if not isinstance(t, torch.Tensor):
        return False
    from torch._subclasses.fake_tensor import FakeTensor
    return isinstance(t, FakeTensor)


@dataclasses.dataclass
class Run:
    """One abstract run's tallies: each kernel's abstract launches, bytes
    and operations; the bytes each collective kind handed to
    ``torch.distributed`` (its operands, this rank's side) and the calls
    over each process group (by name); and the headers posted to each
    peer (global ranks), which a later played rank collects."""

    card: bool = True
    kernels: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict)
    collectives: Dict[str, float] = dataclasses.field(default_factory=dict)
    calls: Dict[str, int] = dataclasses.field(default_factory=dict)
    mail: Dict[tuple, Deque[List[List[int]]]] = dataclasses.field(
        default_factory=lambda: collections.defaultdict(collections.deque))
    sent: Dict[int, List[List[int]]] = dataclasses.field(default_factory=dict)

    def credit(self, kernel: str, nbytes: float, ops: float) -> None:
        k = self.kernels.setdefault(kernel, {"launches": 0, "bytes": 0.0,
                                             "ops": 0.0})
        k["launches"] += 1
        k["bytes"] += float(nbytes)
        k["ops"] += float(ops)

    def collective(self, kind: str, nbytes: float, group: str = "") -> None:
        """Tally one collective of ``kind`` handing ``nbytes`` over the
        process group named ``group``."""
        self.collectives[kind] = self.collectives.get(kind, 0.0) + float(nbytes)
        self.calls[group] = self.calls.get(group, 0) + 1

    def post(self, src: int, dst: int, records: List[List[int]]) -> None:
        self.mail[(src, dst)].append([list(r) for r in records])
        self.sent[len(records)] = [list(r) for r in records]

    def collect(self, src: int, dst: int, n_records: int) -> List[List[int]]:
        """The header ``src`` posted to ``dst``; where that rank was not
        played, the last header of ``n_records`` records this rank posted
        (ranks of one program send their peers what they receive)."""
        box = self.mail.get((src, dst))
        if box:
            got = box.popleft()
        elif n_records in self.sent:
            got = self.sent[n_records]
        else:
            raise RuntimeError(
                f"abstract run: rank {dst} receives {n_records} records from "
                f"rank {src}, which no played rank posted")
        if len(got) != n_records:
            raise RuntimeError(f"abstract run: {len(got)} records posted, "
                               f"{n_records} expected")
        return [list(r) for r in got]


_RUN: Optional[Run] = None


def current() -> Optional[Run]:
    return _RUN


@contextlib.contextmanager
def tracing(run: Optional[Run] = None, *, card: bool = True):
    """Make ``run`` (default: a fresh one) the abstract run in force."""
    global _RUN
    prev, _RUN = _RUN, run if run is not None else Run(card=card)
    try:
        yield _RUN
    finally:
        _RUN = prev


def on_card(*tensors) -> bool:
    """True when a kernel wrapper takes its abstract form: a run tracing
    the card's path is in force and every operand is fake."""
    return (_RUN is not None and _RUN.card and bool(tensors)
            and all(is_fake(t) for t in tensors))


def credit(kernel: str, nbytes: float, ops: float) -> None:
    """Credit one abstract launch of ``kernel`` to the run in force."""
    _require().credit(kernel, nbytes, ops)


def collective(kind: str, nbytes: float, group: str = "") -> None:
    """Tally ``nbytes`` of collective ``kind`` over the group named
    ``group`` to the run in force (no-op outside a run)."""
    if _RUN is not None:
        _RUN.collective(kind, nbytes, group)


def _require() -> Run:
    if _RUN is None:
        raise RuntimeError("a fake tensor outside an abstract run "
                           "(repro_torch.core.abstract.tracing)")
    return _RUN


def host_bool(t) -> bool:
    """``bool(t)``; a fake flag reads True (the stream fits its
    capacity)."""
    if is_fake(t):
        _require()
        return True
    return bool(t)


def host_int(t, static: int) -> int:
    """``int(t)``; a fake count reads ``static`` (every slot in use)."""
    if is_fake(t):
        _require()
        return int(static)
    return int(t)


def used_slots(mask: torch.Tensor, *ts: torch.Tensor):
    """The entries of each of ``ts`` where ``mask`` (the escape slots in
    use) holds, flat, as ``t[mask]`` gives them.  A fake mask selects every
    slot, the dry run's static figure: each ``t`` whole, flattened."""
    if is_fake(mask):
        _require()
        return tuple(t.reshape(-1) for t in ts)
    return tuple(t[mask] for t in ts)


def fill_used_slots(dst: torch.Tensor, mask: torch.Tensor,
                    src: torch.Tensor) -> None:
    """``dst[mask] = src``, the inverse of :func:`used_slots`: under a fake
    mask every slot is in use, and ``src`` fills ``dst`` whole."""
    if is_fake(mask):
        _require()
        dst.copy_(src.reshape(dst.shape))
    else:
        dst[mask] = src


def n_used_slots(count: torch.Tensor, slots: int) -> int:
    """The escape slots in use, ``int(count.sum())``; a fake count reads
    ``slots``, every slot."""
    return host_int(count.sum(), slots)


def host_values(t, static: list) -> list:
    """``t.tolist()``; a fake tensor reads ``static`` (every stream held)."""
    if is_fake(t):
        _require()
        return list(static)
    return t.tolist()


def host_read(fn):
    """``fn()`` with every dispatch mode off: a read of REAL host data (a
    mesh's rank grid, which ``DeviceMesh.mesh`` builds on access), also
    while the dry run's fake mode is in force, under which the read would
    make fake tensors."""
    from torch.utils._python_dispatch import _disable_current_modes
    with _disable_current_modes():
        return fn()
