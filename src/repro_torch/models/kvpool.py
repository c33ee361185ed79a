"""Paged compressed-resident KV pool, the port of ``repro.models.kvpool``.

The transfer plane ships KV as SplitZip streams; this module keeps them
compressed **at rest in device memory** on the decode worker.  Storage is
paged:

* a *page* covers ``tokens_per_page`` tokens of ONE leaf stream (one
  ``(layer, batch)`` row of a cache leaf).  The token count makes the page's
  element count a multiple of the codec chunk for every compressible leaf,
  so a page's streams are a contiguous slice of the wire
  ``CompressedTensor`` streams and admission is reshape + scatter, with **no
  rehydration** (``admit_from_wire``).
* per page and leaf the pool holds the two dense streams plus a page-level
  escape list (positions rebased from chunk-relative to page-relative and
  compacted into ``escape_cap`` slots).  Overflow of either the wire's
  per-chunk capacity or the page capacity demotes to raw residency, never to
  lossy storage.
* a per-``(layer, batch)`` **page table** maps logical page -> physical page
  id (-1 = unmapped); physical ids come from a host-side free-list.
* decode-time growth appends raw tokens to a per-row **tail page**; when a
  row's tail fills, the host flushes it through the codec backend
  (``flush_full_tails``) into fresh pages.  The attention kernels
  (:mod:`repro_torch.kernels.splitzip_attention`) only ever see FULL
  compressed pages plus a raw tail.

Unlike the JAX package's pure functions, the port updates the pool's tensors
IN PLACE (one copy of the pools in device memory): the decode step writes the
new token into ``tail``, and ``flush_full_tails`` / ``free_rows`` write pages
and page tables.  A flush checks and allocates for every leaf before it
writes anything, so a ``ResidencyError`` leaves pools, tables and free-lists
as they were.  Page ids are handed out in the JAX package's order, so pools
and tables compare bitwise across the packages.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import codec as C
from repro_torch.core.codebook import Codebook
from repro_torch.kernels import splitzip_attention as SA
from repro_torch.models import layers as Ly
from repro_torch.models import mla as MLA

# Raw-payload bytes per page per leaf: 32 KiB is 128 tokens of a GQA arch
# with 128 elements a token, and keeps the page escape metadata under 1.2%
# of the payload.
DEFAULT_PAGE_BYTES = 32 * 1024

# One page-level escape slot per 256 payload elements (0.39% of elements);
# pages overflow only on escape-heavy tensors, which demote to raw residency.
ESC_SLOT_PER_ELEMS = 256


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LeafGeometry:
    """Static page geometry of one compressible cache leaf."""

    key: str                 # leaf key, e.g. "k" / "v" / "ckv" / "krope"
    shape: tuple             # full cache shape (L, B, S, *token_dims)
    dtype: str               # container dtype name ("bfloat16", ...)
    fmt: str                 # codec format ("bf16", "fp8_e5m2", ...)
    m: int                   # elements per token (= prod(token_dims))
    page_elems: int          # tokens_per_page * m (multiple of chunk)
    page_chunks: int         # page_elems // chunk
    escape_cap: int          # page-level escape slots
    n_pages: int             # physical pages in this leaf's pool


@dataclasses.dataclass(frozen=True)
class PoolGeometry:
    """Static geometry shared by the pool and the kernels."""

    tokens_per_page: int
    chunk: int
    max_pages: int           # logical pages per (layer, batch) row
    n_layers: int
    batch: int
    max_seq: int
    exponents: tuple
    leaves: Tuple[LeafGeometry, ...]

    def leaf(self, key: str) -> LeafGeometry:
        for lg in self.leaves:
            if lg.key == key:
                return lg
        raise KeyError(key)


def _token_elems(shape: tuple) -> int:
    return int(np.prod(shape[3:])) if len(shape) > 3 else 1


def _itemsize(dtype_name: str) -> int:
    return C.dtype_from_name(dtype_name).itemsize


def tokens_per_page_for(cache: Dict[str, torch.Tensor], chunk: int,
                        page_bytes: int = DEFAULT_PAGE_BYTES) -> int:
    """Largest chunk-aligned token count per page under the byte budget.

    A page of ``Tp`` tokens of a leaf with ``m`` elements a token holds
    ``Tp * m`` elements: a multiple of ``chunk`` for every leaf iff ``Tp`` is
    a multiple of ``lcm over leaves of chunk / gcd(chunk, m)``.  Leaves may
    be ``meta`` tensors: only shapes and dtypes are read."""
    align = 1
    m_max, itemsize_max = 1, 1
    for leaf in cache.values():
        m = _token_elems(tuple(leaf.shape))
        align = math.lcm(align, chunk // math.gcd(chunk, m))
        m_max = max(m_max, m)
        itemsize_max = max(itemsize_max, leaf.element_size())
    target = max(1, page_bytes // (itemsize_max * m_max))
    return max(align, (target // align) * align)


class ResidencyError(RuntimeError):
    """Raised when a stream cannot be admitted/kept compressed-resident.

    The engine catches this and demotes the batch to raw residency, never to
    lossy storage."""


# ---------------------------------------------------------------------------
# state
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PagedLeaf:
    """Device tensors of one leaf's page pool.

    Streams are indexed by physical page id; ``page_table`` is (L, B, P)
    logical -> physical (-1 unmapped); ``tail`` is the raw growth page."""

    sign_mantissa: torch.Tensor   # u8 (n_pages, page_chunks, chunk)
    packed: torch.Tensor          # u8 (n_pages, page_chunks, chunk // 2)
    esc_pos: torch.Tensor         # u16 (n_pages, escape_cap), pad = page_elems
    esc_val: torch.Tensor         # u8 (n_pages, escape_cap)
    esc_cnt: torch.Tensor         # i32 (n_pages, 1)
    page_table: torch.Tensor      # i32 (L, B, P)
    tail: torch.Tensor            # dtype (L, B, tokens_per_page, m)

    def streams(self):
        return (self.sign_mantissa, self.packed, self.esc_pos, self.esc_val,
                self.esc_cnt)


@dataclasses.dataclass
class ResidentState:
    """What a resident decode step consumes and returns: the page pools,
    tables and tails of every leaf, and the per-row length."""

    leaves: Dict[str, PagedLeaf]
    cache_len: torch.Tensor       # (B,) i32
    geom: PoolGeometry


# ---------------------------------------------------------------------------
# stream math (page-level escape rebase and compaction)
# ---------------------------------------------------------------------------

def _page_escapes(pos_c, val_c, cnt_c, *, chunk: int, page_chunks: int,
                  cap_page: int):
    """Per-chunk escape buffers -> page-level buffers.

    Inputs are (..., page_chunks, cap_chunk) positions (u16, chunk-relative,
    padding == chunk) and values, and (..., page_chunks) TRUE counts.
    Outputs are (..., cap_page) page-relative positions (padding ==
    page_elems) and values, plus (...,) true page counts, so a page over
    capacity is detectable by the caller.  The scatter runs in int32 into a
    ``cap_page + 1`` wide buffer whose last column takes everything
    dropped."""
    lead = tuple(pos_c.shape[:-2])
    cap_c = pos_c.shape[-1]
    page_elems = chunk * page_chunks
    dev = pos_c.device
    pos = C.widen(pos_c)                                      # int32
    valid = pos < chunk
    cnt = cnt_c.to(torch.int32)
    clipped = torch.clamp(cnt, max=cap_c)
    base = torch.cumsum(clipped, dim=-1) - clipped            # (..., pc)
    rank = torch.arange(cap_c, dtype=torch.int32, device=dev)
    dest = base[..., None] + rank                             # (..., pc, cap)
    dest = torch.where(valid, dest, cap_page)
    dest = torch.clamp(dest, max=cap_page)
    chunk_base = (torch.arange(page_chunks, dtype=torch.int32, device=dev)
                  * chunk)[:, None]
    pos_page = torch.where(valid, pos + chunk_base, page_elems)
    n_lead = int(np.prod(lead)) if lead else 1
    dest2 = dest.reshape(n_lead, -1).to(torch.int64)
    out_pos = torch.full((n_lead, cap_page + 1), page_elems, dtype=torch.int32,
                         device=dev)
    out_val = torch.zeros((n_lead, cap_page + 1), dtype=torch.int32, device=dev)
    out_pos.scatter_(1, dest2, pos_page.reshape(n_lead, -1))
    out_val.scatter_(1, dest2, val_c.reshape(n_lead, -1).to(torch.int32))
    out_pos = C.narrow_u16(out_pos[:, :cap_page].reshape(*lead, cap_page))
    out_val = out_val[:, :cap_page].to(torch.uint8).reshape(*lead, cap_page)
    cnt_page = cnt.sum(dim=-1, dtype=torch.int32)             # true totals
    return out_pos, out_val, cnt_page


def _paged_views(ct, lg: LeafGeometry, geom: PoolGeometry):
    """A CompressedTensor's flat streams as per-page views with leading dims
    (L, B, P_logical): valid because the streams are row-major over the
    (L, B, S, *tok) leaf and S * m is a multiple of page_elems."""
    L_, B, S = lg.shape[0], lg.shape[1], lg.shape[2]
    P = S // geom.tokens_per_page
    pc, chunk = lg.page_chunks, geom.chunk
    sm = ct.sign_mantissa.reshape(L_, B, P, pc, chunk)
    packed = ct.packed.reshape(L_, B, P, pc, chunk // 2)
    pos = ct.esc_pos.reshape(L_, B, P, pc, ct.cap)
    val = ct.esc_val.reshape(L_, B, P, pc, ct.cap)
    cnt = ct.esc_count.reshape(L_, B, P, pc)
    return sm, packed, pos, val, cnt


def decode_pool_pages(leaf: PagedLeaf, lg: LeafGeometry,
                      geom: PoolGeometry) -> torch.Tensor:
    """All physical pages -> container bits (n_pages, page_elems): the plain
    page decoder, on any device.  The card's attention kernels decode the
    same pages on chip."""
    return SA.decode_pages_plain(leaf.streams(), geom.exponents, lg.fmt,
                                 geom.chunk)


def _index(t: torch.Tensor, idx) -> torch.Tensor:
    """``t[idx]`` for any stream dtype (u16 through its signed view)."""
    return C.unsigned_view(C.signed_view(t)[idx])


def _assign(t: torch.Tensor, idx, value: torch.Tensor) -> None:
    """``t[idx] = value`` for any stream dtype, in place."""
    C.signed_view(t)[idx] = C.signed_view(value)


# ---------------------------------------------------------------------------
# the pool
# ---------------------------------------------------------------------------

class KVPool:
    """Host-side owner of the paged compressed KV pool: geometry, the
    free-list of physical pages (one namespace per leaf), the codec backend
    for tail flushes, and the current :class:`ResidentState`."""

    def __init__(self, geom: PoolGeometry, backend, codebook: Codebook,
                 device=None):
        self.geom = geom
        self.backend = backend
        self.codebook = codebook
        self.device = torch.device(device if device is not None else "cpu")
        if tuple(codebook.exponents) != tuple(geom.exponents):
            raise ValueError("codebook/geometry exponent mismatch")
        self._free: Dict[str, list] = {
            lg.key: list(range(lg.n_pages - 1, -1, -1)) for lg in geom.leaves}
        self.state = ResidentState(
            leaves={lg.key: self._empty_leaf(lg) for lg in geom.leaves},
            cache_len=torch.zeros((geom.batch,), dtype=torch.int32,
                                  device=self.device),
            geom=geom)

    # -- construction ------------------------------------------------------

    @classmethod
    def for_cache(cls, cache: Dict[str, torch.Tensor], codebook: Codebook,
                  backend, *, chunk: int, page_bytes: int = DEFAULT_PAGE_BYTES,
                  compressible: Optional[Dict[str, str]] = None) -> "KVPool":
        """A pool sized for ``cache`` (dict of (L, B, S, ...) leaves), on the
        leaves' device.

        ``compressible`` maps leaf key -> codec fmt (default: every bf16
        leaf as "bf16", fp8_e5m2 leaves as their format).  S must be a
        multiple of the derived ``tokens_per_page``."""
        if compressible is None:
            compressible = {}
            for k, v in cache.items():
                if v.dtype == torch.bfloat16:
                    compressible[k] = "bf16"
                elif v.dtype == torch.float8_e5m2:
                    compressible[k] = "fp8_e5m2"
        if len(codebook.exponents) > 16:
            raise ResidencyError("resident pool requires a nibble-packed "
                                 "(k<=16) codebook")
        tp = tokens_per_page_for(
            {k: cache[k] for k in compressible}, chunk, page_bytes)
        first = next(iter(compressible))
        L_, B, S = cache[first].shape[:3]
        if S % tp:
            raise ResidencyError(
                f"max_seq {S} not a multiple of tokens_per_page {tp}")
        P = S // tp
        leaves = []
        for k in compressible:
            arr = cache[k]
            m = _token_elems(tuple(arr.shape))
            pe = tp * m
            leaves.append(LeafGeometry(
                key=k, shape=tuple(arr.shape), dtype=C.dtype_name(arr.dtype),
                fmt=compressible[k], m=m, page_elems=pe,
                page_chunks=pe // chunk,
                escape_cap=max(8, pe // ESC_SLOT_PER_ELEMS),
                n_pages=L_ * B * P))
        geom = PoolGeometry(
            tokens_per_page=tp, chunk=chunk, max_pages=P, n_layers=L_,
            batch=B, max_seq=S, exponents=tuple(codebook.exponents),
            leaves=tuple(leaves))
        return cls(geom, backend, codebook, device=cache[first].device)

    def _empty_leaf(self, lg: LeafGeometry) -> PagedLeaf:
        g, dev = self.geom, self.device
        u8 = dict(dtype=torch.uint8, device=dev)
        return PagedLeaf(
            sign_mantissa=torch.zeros((lg.n_pages, lg.page_chunks, g.chunk), **u8),
            packed=torch.zeros((lg.n_pages, lg.page_chunks, g.chunk // 2), **u8),
            esc_pos=C.narrow_u16(torch.full((lg.n_pages, lg.escape_cap),
                                            lg.page_elems, dtype=torch.int32,
                                            device=dev)),
            esc_val=torch.zeros((lg.n_pages, lg.escape_cap), **u8),
            esc_cnt=torch.zeros((lg.n_pages, 1), dtype=torch.int32, device=dev),
            page_table=torch.full((g.n_layers, g.batch, g.max_pages), -1,
                                  dtype=torch.int32, device=dev),
            tail=torch.zeros((g.n_layers, g.batch, g.tokens_per_page, lg.m),
                             dtype=C.dtype_from_name(lg.dtype), device=dev))

    # -- free-list ---------------------------------------------------------

    def _alloc(self, key: str, n: int) -> np.ndarray:
        free = self._free[key]
        if len(free) < n:
            raise ResidencyError(f"leaf {key!r}: pool exhausted "
                                 f"({n} pages requested, {len(free)} free)")
        return np.array([free.pop() for _ in range(n)], np.int32)

    def _release(self, key: str, ids) -> None:
        self._free[key].extend(int(i) for i in ids)

    def free_pages(self, key: str) -> int:
        return len(self._free[key])

    def allocated_pages(self, key: str) -> int:
        return self.geom.leaf(key).n_pages - len(self._free[key])

    def _ids(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=torch.int64,
                               device=self.device)

    # -- admission (zero rehydration) --------------------------------------

    def admit_from_wire(self, comp: Dict[str, object],
                        cache_len: torch.Tensor) -> ResidentState:
        """Map received ``CompressedTensor`` streams into pages.

        Pages are contiguous stream slices, so admission is reshape +
        page-escape compaction + scatter by physical page id.  Only the
        sub-page tail (``cache_len % tokens_per_page`` tokens per row) goes
        through the backend's decode, one page-group per (layer, row).
        Raises :class:`ResidencyError` (the caller demotes) on any
        unsupported stream or page-escape overflow."""
        g = self.geom
        cache_len = torch.as_tensor(cache_len, dtype=torch.int32,
                                    device=self.device)
        lens = cache_len.cpu().numpy()
        n_full = lens // g.tokens_per_page
        leaves = {}
        for lg in g.leaves:
            ct = comp.get(lg.key)
            if ct is None:
                raise ResidencyError(
                    f"leaf {lg.key!r} arrived raw (codec fallback); "
                    "cannot admit compressed-resident")
            if getattr(ct, "layout", None) != "chunked":
                raise ResidencyError(f"leaf {lg.key!r}: layout "
                                     f"{getattr(ct, 'layout', None)!r} "
                                     "not admissible (need 'chunked')")
            if ct.chunk != g.chunk or tuple(ct.exponents) != g.exponents:
                raise ResidencyError(
                    f"leaf {lg.key!r}: wire chunk/codebook mismatch")
            if tuple(ct.shape) != lg.shape:
                raise ResidencyError(
                    f"leaf {lg.key!r}: wire shape {ct.shape} != pool shape "
                    f"{lg.shape}")
            leaves[lg.key] = self._admit_leaf(ct, lg, lens, n_full)
        self.state = ResidentState(leaves=leaves, cache_len=cache_len, geom=g)
        return self.state

    def _admit_leaf(self, ct, lg: LeafGeometry, lens: np.ndarray,
                    n_full: np.ndarray) -> PagedLeaf:
        g = self.geom
        leaf = self._empty_leaf(lg)
        sm, packed, pos_c, val_c, cnt_c = _paged_views(ct, lg, g)
        pos_pg, val_pg, cnt_pg = _page_escapes(
            pos_c, val_c, cnt_c, chunk=g.chunk, page_chunks=lg.page_chunks,
            cap_page=lg.escape_cap)

        # admitted (l, b, p) triples in (row, page, layer) order: every
        # layer, the rows' full pages only
        trip = [(l, b, p) for b in range(g.batch) for p in range(int(n_full[b]))
                for l in range(g.n_layers)]
        if trip:
            idx = tuple(self._ids(a) for a in np.array(trip).T)
            cnts = cnt_pg[idx].cpu().numpy()
            if (cnts > lg.escape_cap).any():
                raise ResidencyError(
                    f"leaf {lg.key!r}: page escape overflow "
                    f"(max {int(cnts.max())} > cap {lg.escape_cap})")
            pids = self._ids(self._alloc(lg.key, len(trip)))
            leaf.sign_mantissa[pids] = sm[idx]
            leaf.packed[pids] = packed[idx]
            _assign(leaf.esc_pos, pids, _index(pos_pg, idx))
            leaf.esc_val[pids] = val_pg[idx]
            leaf.esc_cnt[pids, 0] = cnt_pg[idx]
            leaf.page_table[idx] = pids.to(torch.int32)

        # tail: bounded decode of ONE page-group per (layer, row)
        if (lens % g.tokens_per_page).any():
            leaf.tail = self._decode_wire_tail(ct, lg, n_full)
        return leaf

    def _decode_wire_tail(self, ct, lg: LeafGeometry,
                          n_full: np.ndarray) -> torch.Tensor:
        """Gather each (layer, row)'s tail page-group chunks into a small
        CompressedTensor and decode it through the backend."""
        g = self.geom
        L_, B = g.n_layers, g.batch
        pc, chunk = lg.page_chunks, g.chunk
        chunks_per_row = (lg.shape[2] * lg.m) // chunk        # S*m/chunk
        start = (np.arange(L_)[:, None] * B + np.arange(B)[None, :]) \
            * chunks_per_row + np.minimum(n_full[None, :], g.max_pages - 1) * pc
        gather = self._ids((start[..., None] + np.arange(pc)).reshape(-1))
        n_chunks_total = ct.sign_mantissa.shape[0] // chunk
        sm = ct.sign_mantissa.reshape(n_chunks_total, chunk)[gather]
        packed = ct.packed.reshape(n_chunks_total, chunk // 2)[gather]
        sub = C.CompressedTensor(
            sign_mantissa=sm.reshape(-1), packed=packed.reshape(-1),
            esc_pos=_index(ct.esc_pos, gather), esc_val=ct.esc_val[gather],
            esc_count=ct.esc_count[gather],
            ok=torch.tensor(True, device=self.device),
            shape=(L_ * B * pc * chunk,), dtype=lg.dtype, fmt=lg.fmt,
            exponents=g.exponents, chunk=chunk, cap=ct.cap, layout="chunked")
        vals = self.backend.decode(sub)
        return vals.reshape(L_, B, g.tokens_per_page, lg.m)

    # -- decode-time growth ------------------------------------------------

    def flush_full_tails(self, state: ResidentState) -> ResidentState:
        """Recompress rows whose tail page just filled into fresh pages.

        Host-side, between steps.  A row needs flushing when its logical page
        ``cache_len // Tp - 1`` is still unmapped but fully covered.  Encodes
        the whole tail leaf once per call and scatters only the needy rows.
        Every leaf is encoded and checked, and every leaf's pages are
        allocated, before anything is written: a :class:`ResidencyError`
        (escape overflow, exhaustion) leaves the pool as it was."""
        g = self.geom
        tp = g.tokens_per_page
        lens = state.cache_len.cpu().numpy()
        full_page = lens // tp - 1                           # (B,)
        due = [b for b in range(g.batch) if lens[b] > 0 and lens[b] % tp == 0]
        rows = []
        if due:
            table0 = state.leaves[g.leaves[0].key].page_table[0].cpu().numpy()
            rows = [b for b in due if table0[b, full_page[b]] < 0]
        if not rows:
            self.state = state
            return state
        rows_np = np.array(rows)
        idx_l = np.repeat(np.arange(g.n_layers), len(rows))
        idx_b = np.tile(rows_np, g.n_layers)
        idx_p = full_page[idx_b]
        il, ib, ip = self._ids(idx_l), self._ids(idx_b), self._ids(idx_p)
        # phase 1: encode + overflow-check every leaf
        staged = []
        for lg in g.leaves:
            leaf = state.leaves[lg.key]
            ct = self.backend.encode(
                leaf.tail.reshape(-1), self.codebook, chunk=g.chunk,
                cap=lg.escape_cap, layout="chunked")
            pc = lg.page_chunks
            sm = ct.sign_mantissa.reshape(g.n_layers, g.batch, pc, g.chunk)
            packed = ct.packed.reshape(g.n_layers, g.batch, pc, g.chunk // 2)
            pos_c = ct.esc_pos.reshape(g.n_layers, g.batch, pc, -1)
            val_c = ct.esc_val.reshape(g.n_layers, g.batch, pc, -1)
            cnt_c = ct.esc_count.reshape(g.n_layers, g.batch, pc)
            pos_pg, val_pg, cnt_pg = _page_escapes(
                pos_c, val_c, cnt_c, chunk=g.chunk, page_chunks=pc,
                cap_page=lg.escape_cap)
            cnts = cnt_pg[il, ib].cpu().numpy()
            if (cnts > lg.escape_cap).any():
                raise ResidencyError(
                    f"leaf {lg.key!r}: tail recompress escape overflow "
                    f"(max {int(cnts.max())} > cap {lg.escape_cap})")
            staged.append((lg, sm, packed, pos_pg, val_pg, cnt_pg))
        # phase 2: allocate for every leaf; an exhaustion returns the pages
        # already popped for earlier leaves
        alloced = []
        try:
            for lg, *_ in staged:
                alloced.append((lg.key, self._alloc(lg.key, len(idx_l))))
        except ResidencyError:
            for key, pids in alloced:
                self._release(key, pids)
            raise
        # phase 3: write
        for (lg, sm, packed, pos_pg, val_pg, cnt_pg), (_, pids) in zip(staged,
                                                                      alloced):
            leaf = state.leaves[lg.key]
            pid = self._ids(pids)
            leaf.sign_mantissa[pid] = sm[il, ib]
            leaf.packed[pid] = packed[il, ib]
            _assign(leaf.esc_pos, pid, _index(pos_pg, (il, ib)))
            leaf.esc_val[pid] = val_pg[il, ib]
            leaf.esc_cnt[pid, 0] = cnt_pg[il, ib]
            leaf.page_table[il, ib, ip] = pid.to(torch.int32)
        self.state = state
        return state

    # -- fallback / teardown ----------------------------------------------

    def rehydrate(self, state: Optional[ResidentState] = None
                  ) -> Dict[str, torch.Tensor]:
        """Reconstruct the raw cache dict, bit-exact (demotion, checks).

        Unmapped pages and tokens beyond ``cache_len`` come back zero-filled.
        A row at a page boundary whose just-filled page is still UNMAPPED (a
        flush failed before writing the table) holds that page's data only
        in the tail: the FULL tail is spliced there, not an empty one at
        ``n_full``.  On the card the pages decode through the kernels' page
        decoder (:func:`~repro_torch.kernels.splitzip_attention.decode_pages`)."""
        state = state or self.state
        g = self.geom
        tp = g.tokens_per_page
        L_, B = g.n_layers, g.batch
        dev = self.device
        out = {}
        for lg in g.leaves:
            leaf = state.leaves[lg.key]
            bits = C.signed_view(SA.decode_pages(leaf.streams(), g.exponents,
                                                 lg.fmt, g.chunk))
            bits = torch.cat([bits, torch.zeros((1, lg.page_elems),
                                                dtype=bits.dtype, device=dev)])
            table = torch.where(leaf.page_table < 0, lg.n_pages,
                                leaf.page_table).to(torch.int64)
            vals = bits[table].reshape(L_, B, g.max_pages, tp, lg.m)
            n_full = (state.cache_len // tp).to(torch.int64)     # (B,)
            tail_tok = (state.cache_len % tp).to(torch.int64)
            prev = torch.clamp(n_full - 1, min=0)
            prev_pid = torch.gather(
                leaf.page_table, 2,
                prev[None, :, None].expand(L_, B, 1))[..., 0]    # (L, B)
            pending = ((tail_tok[None, :] == 0) & (n_full[None, :] > 0)
                       & (prev_pid < 0))                         # (L, B)
            eff_page = torch.where(pending, prev[None, :], n_full[None, :])
            eff_tok = torch.where(pending, tp, tail_tok[None, :])
            t_idx = torch.arange(tp, device=dev)
            tail_mask = t_idx[None, None, :] < eff_tok[..., None]
            tail = C.signed_view(C.to_bits(leaf.tail, lg.fmt))   # bits, not floats
            tail = torch.where(tail_mask[..., None], tail, 0).to(bits.dtype)
            p_idx = torch.arange(g.max_pages, device=dev)
            is_tail_page = p_idx[None, None, :] == eff_page[..., None]
            vals = torch.where(is_tail_page[..., None, None], tail[:, :, None],
                               vals)
            vals = C.from_bits(C.unsigned_view(vals), C.dtype_from_name(lg.dtype))
            out[lg.key] = vals.reshape(L_, B, g.max_seq, *lg.shape[3:])
        return out

    def free_rows(self, rows) -> None:
        """Return all physical pages of the given batch rows to the
        free-list and unmap them (sequence eviction)."""
        for lg in self.geom.leaves:
            leaf = self.state.leaves[lg.key]
            table = leaf.page_table.cpu().numpy()
            for b in rows:
                ids = table[:, b, :].reshape(-1)
                self._release(lg.key, ids[ids >= 0])
                leaf.page_table[:, b, :] = -1

    # -- accounting --------------------------------------------------------

    def page_bytes(self, lg: LeafGeometry) -> int:
        """Device bytes of ONE physical page (streams + escape metadata)."""
        return (lg.page_elems + lg.page_elems // 2
                + lg.escape_cap * 3 + 4)

    def hbm_bytes(self, *, allocated_only: bool = False) -> int:
        """Resident footprint: page pools (+ tables + tails)."""
        g = self.geom
        total = 0
        for lg in g.leaves:
            n = (self.allocated_pages(lg.key) if allocated_only
                 else lg.n_pages)
            total += n * self.page_bytes(lg)
            total += g.n_layers * g.batch * g.max_pages * 4   # page table
            total += (g.n_layers * g.batch * g.tokens_per_page * lg.m
                      * _itemsize(lg.dtype))                   # tail
        return total

    def raw_bytes(self) -> int:
        """What the same cache costs raw-resident."""
        g = self.geom
        return sum(g.n_layers * g.batch * g.max_seq * lg.m
                   * _itemsize(lg.dtype) for lg in g.leaves)

    def resident_ratio(self) -> float:
        """raw / resident: the decode worker's capacity multiplier."""
        return self.raw_bytes() / self.hbm_bytes()


# ---------------------------------------------------------------------------
# decode-step glue (one kernel launch per attention layer)
# ---------------------------------------------------------------------------

def _append_tail(tail: torch.Tensor, new: torch.Tensor, t: torch.Tensor) -> None:
    """Write each row's new token (B, 1, m) into its tail page (B, Tp, m) at
    slot ``t`` (B,), in place."""
    rows = torch.arange(tail.shape[0], device=tail.device)
    tail[rows, t.to(torch.int64)] = new[:, 0].to(tail.dtype)


def paged_decode_attention_block(p, x, k_streams, v_streams, pt_k, pt_v,
                                 tail_k, tail_v, cache_len, theta, *,
                                 geom: PoolGeometry, fmt: str = "bf16"):
    """Mirror of ``layers.decode_attention_block`` over a compressed prefix.

    The prefix (``cache_len // Tp`` full pages) goes through the paged GQA
    kernel; the new token is appended to the raw tail page (in place) and
    the tail partials merge in plain PyTorch.  ``pt_*``/``tail_*`` are THIS
    layer's page-table rows (B, P) and tail pages (B, Tp, m)."""
    tp = geom.tokens_per_page
    positions = cache_len[:, None]
    q, k, v = Ly.attention_qkv(p, x, positions, theta)
    b, _, hkv, hd = k.shape
    h = q.shape[2]
    g = h // hkv
    dv = v.shape[-1]
    t = cache_len % tp
    _append_tail(tail_k, k.reshape(b, 1, hkv * hd), t)
    _append_tail(tail_v, v.reshape(b, 1, hkv * dv), t)

    scale = 1.0 / np.sqrt(hd)
    acc, m, l = SA.paged_gqa_attention(
        q.contiguous(), k_streams, v_streams, pt_k, pt_v, cache_len,
        exponents=geom.exponents, fmt=fmt, chunk=geom.chunk,
        tokens_per_page=tp, hkv=hkv, causal=True, scale=scale)
    part = (acc.reshape(b, 1, hkv, g, dv), m.reshape(b, 1, hkv, g),
            l.reshape(b, 1, hkv, g))
    tk = tail_k.reshape(b, tp, hkv, hd).float()
    tv = tail_v.reshape(b, tp, hkv, dv).float()
    qf = q.float().reshape(b, 1, hkv, g, hd)
    s_t = torch.einsum("bqhgd,bthd->bqhgt", qf, tk) * scale
    o = SA.attend_tail(part, s_t, tv, t, x.dtype).reshape(b, 1, h, dv)
    return Ly.attention_out(p, o), (tail_k, tail_v)


def paged_mla_decode(p, x, ckv_streams, kr_streams, pt_c, pt_r, tail_c,
                     tail_r, cache_len, cfg, theta, *, geom: PoolGeometry,
                     fmt: str = "bf16"):
    """Mirror of ``mla.mla_decode`` over compressed latent pages.

    Scores and context run in the latent space inside the kernel (absorbed
    form); the ``w_v``/``wo`` up-projections apply after the tail merge."""
    tp = geom.tokens_per_page
    positions = cache_len[:, None]
    q_nope, q_rope = MLA.queries(p, x, positions, cfg, theta)      # (B,1,H,·)
    c_new, kr_new = MLA.latent_kv(p, x, positions, cfg, theta)     # (B,1,r/p)
    t = cache_len % tp
    _append_tail(tail_c, c_new, t)
    _append_tail(tail_r, kr_new, t)
    q_lat, w_v = MLA.absorbed_query(p, q_nope, cfg)
    scale = MLA.mla_scale(cfg)

    acc, m, l = SA.paged_mla_attention(
        q_lat.contiguous(), q_rope.contiguous(), ckv_streams, kr_streams,
        pt_c, pt_r, cache_len, exponents=geom.exponents, fmt=fmt,
        chunk=geom.chunk, tokens_per_page=tp, scale=scale, causal=True)

    tc, tr = tail_c.float(), tail_r.float()                        # (B,Tp,·)
    qlf, qrf = q_lat.float(), q_rope.float()
    s_t = (torch.einsum("bqhr,btr->bqht", qlf, tc)
           + torch.einsum("bqhp,btp->bqht", qrf, tr)) * scale
    ctx_lat = SA.attend_tail((acc, m, l), s_t, tc, t, tail_c.dtype)  # (B,1,H,r)
    return MLA.latent_out(p, ctx_lat, w_v), (tail_c, tail_r)


def bytes_per_token_resident(m: int, tokens_per_page: int,
                             *, chunk: int = 1024,
                             esc_slot_per_elems: int = ESC_SLOT_PER_ELEMS
                             ) -> float:
    """Analytic device bytes a token of the paged resident format: 1.5 B an
    element of dense streams (sign-mantissa byte + packed nibble) plus the
    page escape metadata, independent of the source dtype.  ``m`` is
    compressed elements a token (all compressible leaves summed)."""
    pe = tokens_per_page * m
    cap = max(8, pe // esc_slot_per_elems)
    return (pe + pe // 2 + cap * 3 + 4) / tokens_per_page
