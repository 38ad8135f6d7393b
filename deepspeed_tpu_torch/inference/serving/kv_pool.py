"""Paged KV-cache pool for continuous-batching inference.

Port of ``deepspeed_tpu/inference/serving/kv_pool.py``. Keys and values
live in fixed-size pages ``[L, n_pages, nh, page_tokens, hd]`` on the
device; a lane (slot) owns the pages its host-side page table
``[max_slots, pages_per_lane]`` points at. Physical page 0 is the null
page: it is never allocated, table rows are zeroed on free, and every
write from an inactive lane or past a lane's pages is routed to it, so a
page reallocated to a new request is never corrupted by its previous
owner. ``page_tokens`` divides ``max_seq_len``, so a full lane is exactly
``pages_per_lane`` pages.

Storage dtype: "fp32" stores the model's compute dtype, "bf16" halves
the bytes, "int8" quarters them with per-(layer, slot, head) symmetric
fp32 scales set at install from the prefilled lane and fixed while the
lane decodes. The pool is updated in place.

``export_lane`` / ``install_raw`` carry a live lane between two pools
for the fleet's disaggregated prefill/decode handoff: the pages as stored
(storage-dtype bytes, never dequantized), one frame a logical page (its
k bytes, then its v bytes, each ``[L, nh, page_tokens, hd]`` in C
order), and in int8 mode a trailing frame with the lane's per-(layer,
head) k scales, then v scales (fp32 ``[L, nh, 1, 1]``, the JAX package's
per-slot layout), with the JAX package's meta keys.

``export_entry_frames`` / ``import_entry_frames`` turn a host-side KV
entry (CPU tensors in their storage dtype) into raw byte frames and back,
bit for bit, with the JAX package's meta dict: the prefix cache's spill
tier stores them. bf16 goes through its 16-bit pattern, so a blob's bytes
and meta are the JAX package's without ``ml_dtypes``.
"""

import math

import numpy as np
import torch

from deepspeed_tpu_torch.inference.generation import (
    DEFAULT_PAGE_TOKENS,
    resolve_page_tokens,
)
from deepspeed_tpu_torch.inference.quantization import quantize_kv

KV_CACHE_DTYPES = ("fp32", "bf16", "int8")


class PoolExhaustedError(RuntimeError):
    """allocate() found no free slot or not enough free pages; the
    engine keeps the request queued."""


class PageStateError(ValueError):
    """A page/slot lifecycle violation: a double free, or an install into
    a slot that was never allocated."""


class KVCachePool:
    """Fixed-capacity paged KV storage on ``device`` plus its host-side
    allocator."""

    def __init__(self, n_layers, max_slots, n_heads, max_seq_len, head_dim,
                 dtype=torch.float32, kv_cache_dtype="fp32", page_tokens=None,
                 pool_tokens=None, device="cuda", model_parallel=1):
        if max_slots < 1:
            raise ValueError(f"max_slots must be >= 1, got {max_slots}")
        if max_seq_len < 2:
            raise ValueError(f"max_seq_len must be >= 2, got {max_seq_len}")
        if kv_cache_dtype not in KV_CACHE_DTYPES:
            raise ValueError(f"kv_cache_dtype must be one of {KV_CACHE_DTYPES}, "
                             f"got {kv_cache_dtype!r}")
        self.n_layers = int(n_layers)
        self.max_slots = int(max_slots)
        # a tensor-parallel pool holds this rank's n_heads / model_parallel
        # heads of every page
        self.model_parallel = int(model_parallel)
        if int(n_heads) % self.model_parallel != 0:
            raise ValueError(
                f"n_heads={n_heads} not divisible by the mesh's model axis "
                f"size {self.model_parallel}; the KV pool shards heads")
        self.n_heads = int(n_heads) // self.model_parallel
        self.max_seq_len = int(max_seq_len)
        self.head_dim = int(head_dim)
        self.device = torch.device(device)
        self.compute_dtype = dtype
        self.kv_cache_dtype = kv_cache_dtype
        self.page_tokens = resolve_page_tokens(
            page_tokens or DEFAULT_PAGE_TOKENS, self.max_seq_len)
        self.pages_per_lane = self.max_seq_len // self.page_tokens
        if pool_tokens is None:
            pool_tokens = self.max_slots * self.max_seq_len
        if int(pool_tokens) < 1:
            raise ValueError(f"pool_tokens must be >= 1, got {pool_tokens}")
        # floor of one full lane so a max-length request always fits
        self.pool_tokens = max(int(pool_tokens),
                               self.pages_per_lane * self.page_tokens)
        self.n_data_pages = self.pool_tokens // self.page_tokens
        n_pages = self.n_data_pages + 1                  # + null page 0
        shape = (self.n_layers, n_pages, self.n_heads, self.page_tokens,
                 self.head_dim)
        storage = {"fp32": dtype, "bf16": torch.bfloat16,
                   "int8": torch.int8}[kv_cache_dtype]
        self.k = torch.zeros(shape, dtype=storage, device=self.device)
        self.v = torch.zeros(shape, dtype=storage, device=self.device)
        if kv_cache_dtype == "int8":
            # one symmetric scale per (layer, slot, head): pages are never
            # shared between lanes
            sshape = (self.n_layers, self.max_slots, self.n_heads, 1, 1)
            self.k_scale = torch.ones(sshape, dtype=torch.float32, device=self.device)
            self.v_scale = torch.ones(sshape, dtype=torch.float32, device=self.device)
        else:
            self.k_scale = None
            self.v_scale = None
        # lowest-index-first allocation keeps slot/page assignment
        # deterministic for a given arrival order
        self._free = sorted(range(self.max_slots), reverse=True)
        self._free_pages = sorted(range(1, n_pages), reverse=True)
        # logical -> physical page per lane; 0 (the null page) = unmapped
        self.page_tables = np.zeros((self.max_slots, self.pages_per_lane), np.int32)
        self._lane_pages = [[] for _ in range(self.max_slots)]
        # handoff idempotency: key -> slot for lanes installed by
        # install_raw(); a re-sent handoff under a live key is a no-op
        self._handoff_keys = {}
        self._slot_handoff_key = {}
        # per-slot next write/read position (== tokens cached so far)
        self.positions = np.zeros(self.max_slots, np.int32)
        self.allocations = 0
        self.frees = 0
        self.peak_in_use = 0
        self.peak_pages_in_use = 0

    # -- slot lifecycle -------------------------------------------------
    @property
    def slots_in_use(self):
        return self.max_slots - len(self._free)

    @property
    def free_slots(self):
        return len(self._free)

    @property
    def pages_in_use(self):
        return self.n_data_pages - len(self._free_pages)

    @property
    def free_pages(self):
        return len(self._free_pages)

    def _pages_needed(self, n_tokens):
        if n_tokens is None:
            n_tokens = self.max_seq_len
        n_tokens = min(max(int(n_tokens), 1), self.max_seq_len)
        return -(-n_tokens // self.page_tokens)

    def can_allocate(self, n_tokens=None):
        return (bool(self._free)
                and self._pages_needed(n_tokens) <= len(self._free_pages))

    def allocate(self, n_tokens=None):
        """Claim the lowest free slot plus enough pages for ``n_tokens``
        positions (default: a full lane). PoolExhaustedError when out of
        slots or pages; the pool is untouched on failure."""
        if not self._free:
            raise PoolExhaustedError(
                f"all {self.max_slots} KV-cache slots are in use")
        need = self._pages_needed(n_tokens)
        if need > len(self._free_pages):
            raise PoolExhaustedError(
                f"KV page pool exhausted: need {need} pages, "
                f"{len(self._free_pages)} of {self.n_data_pages} free")
        slot = self._free.pop()
        pages = [self._free_pages.pop() for _ in range(need)]
        self.page_tables[slot] = 0
        self.page_tables[slot, :need] = pages
        self._lane_pages[slot] = pages
        self.allocations += 1
        self.peak_in_use = max(self.peak_in_use, self.slots_in_use)
        self.peak_pages_in_use = max(self.peak_pages_in_use, self.pages_in_use)
        self.positions[slot] = 0
        return slot

    def free(self, slot):
        if not 0 <= slot < self.max_slots:
            raise ValueError(f"slot {slot} outside [0, {self.max_slots})")
        if slot in self._free:
            raise PageStateError(f"slot {slot} is already free (double free)")
        key = self._slot_handoff_key.pop(slot, None)
        if key is not None:
            self._handoff_keys.pop(key, None)
        self.frees += 1
        self.positions[slot] = 0
        # zero the table row before returning pages: the freed lane's
        # masked writes must route to the null page from the next uploaded
        # table on, never to a page someone else now owns
        self.page_tables[slot] = 0
        self._free_pages.extend(self._lane_pages[slot])
        self._free_pages.sort(reverse=True)
        self._lane_pages[slot] = []
        self._free.append(slot)
        self._free.sort(reverse=True)

    def install_lane(self, batch_k, batch_v, lane, slot, position):
        """Install lane ``lane`` of a batched prefill result
        ([L, B, nh, S, hd], S >= max_seq_len, compute dtype) into
        ``slot``'s pages and set its position counter (= prompt length).
        Unallocated logical pages carry destination 0 and land on the
        null page; int8 mode quantizes the lane with fresh per-(layer,
        head) scales over its whole span."""
        if not 0 <= position < self.max_seq_len:
            raise ValueError(f"position {position} outside [0, {self.max_seq_len})")
        if slot in self._free:
            raise PageStateError(f"install into slot {slot} which is not allocated")
        L, nh, mp, pt, hd = (self.n_layers, self.n_heads, self.pages_per_lane,
                             self.page_tokens, self.head_dim)
        dest = torch.as_tensor(self.page_tables[slot], dtype=torch.long,
                               device=self.device)

        def paged(lane_kv):                               # [L, nh, span, hd]
            return lane_kv.reshape(L, nh, mp, pt, hd).transpose(1, 2)

        for side, buf, scale in ((self.k, batch_k, self.k_scale),
                                 (self.v, batch_v, self.v_scale)):
            lane_kv = buf[:, lane, :, :mp * pt]
            if self.kv_cache_dtype == "int8":
                q, s = quantize_kv(lane_kv)
                side[:, dest] = paged(q)
                scale[:, slot] = s
            else:
                side[:, dest] = paged(lane_kv).to(side.dtype)
        self.positions[slot] = position

    def install(self, k, v, slot, position):
        """Install a single-lane prefill cache ([L, 1, nh, S, hd], compute
        dtype; chunked prefill's private cache) into ``slot``."""
        self.install_lane(k, v, lane=0, slot=slot, position=position)

    # -- raw page export / install (disaggregated handoff) --------------
    def _check_whole_heads(self, what):
        if self.model_parallel > 1:
            raise NotImplementedError(
                f"{what}: the KV handoff of a heads-sharded lane (model_parallel="
                f"{self.model_parallel}) is not ported to deepspeed_tpu_torch yet "
                "(ROADMAP.md, queue 1)")

    def export_lane(self, slot):
        """Copy a live lane's pages as stored (storage-dtype bytes, no
        dequantization: the transfer is bitwise) to host memory. Returns
        ``(meta, frames)``: one ``bytes`` payload a logical page (k bytes,
        then v bytes, fixed length), plus a trailing scales frame in int8
        mode; ``meta`` holds what ``install_raw`` needs to rebuild the lane
        bit for bit in another pool of the same geometry."""
        self._check_whole_heads("export_lane")
        if slot in self._free:
            raise PageStateError(f"export from slot {slot} which is not allocated")
        pages = self._lane_pages[slot]
        idx = torch.as_tensor(pages, dtype=torch.long, device=self.device)
        # advanced indexing copies; the host copy never aliases the pool
        lane_k = self.k[:, idx].to("cpu", copy=True)        # [L, n, nh, pt, hd]
        lane_v = self.v[:, idx].to("cpu", copy=True)
        frames = [_raw_bytes(lane_k[:, i]) + _raw_bytes(lane_v[:, i])
                  for i in range(len(pages))]
        meta = {
            "pages": len(pages),
            "position": int(self.positions[slot]),
            "page_tokens": self.page_tokens,
            "kv_cache_dtype": self.kv_cache_dtype,
            "page_nbytes": len(frames[0]) if frames else 0,
            "scales": self.k_scale is not None,
        }
        if self.k_scale is not None:
            frames.append(_raw_bytes(self.k_scale[:, slot].float())
                          + _raw_bytes(self.v_scale[:, slot].float()))
        return meta, frames

    def install_raw(self, slot, meta, frames, handoff_key=None):
        """Install exported pages into an allocated ``slot`` without
        re-quantizing: the bytes land in storage as the sender stored
        them, so the resumed lane equals the prefill replica's bit for
        bit. Idempotent under ``handoff_key``: a re-sent handoff whose key
        is live returns False and touches nothing; installing over a live
        lane held under another key raises PageStateError."""
        self._check_whole_heads("install_raw")
        if slot in self._free:
            raise PageStateError(f"install_raw into slot {slot} which is not allocated")
        if handoff_key is not None and handoff_key in self._handoff_keys:
            return False                                   # idempotent re-send
        held = self._slot_handoff_key.get(slot)
        if held is not None and held != handoff_key:
            raise PageStateError(
                f"slot {slot} already holds handoff key {held!r}; refusing "
                f"install over a live lane under {handoff_key!r}")
        n = int(meta["pages"])
        if meta["kv_cache_dtype"] != self.kv_cache_dtype:
            raise PageStateError(f"handoff dtype {meta['kv_cache_dtype']!r} does not "
                                 f"match pool dtype {self.kv_cache_dtype!r}")
        if n > len(self._lane_pages[slot]):
            raise PageStateError(f"handoff carries {n} pages but slot {slot} has only "
                                 f"{len(self._lane_pages[slot])} allocated")
        position = int(meta["position"])
        if not 0 <= position < self.max_seq_len:
            raise ValueError(f"position {position} outside [0, {self.max_seq_len})")
        pshape = (self.n_layers, self.n_heads, self.page_tokens, self.head_dim)
        half = self.k.element_size() * math.prod(pshape)
        for payload in frames[:n]:
            if len(payload) != 2 * half:
                raise PageStateError(f"page frame carries {len(payload)} bytes, the "
                                     f"pool's pages need {2 * half}")
        lane_k = torch.stack([_from_bytes(f[:half], self.k.dtype, pshape)
                              for f in frames[:n]], dim=1)   # [L, n, nh, pt, hd]
        lane_v = torch.stack([_from_bytes(f[half:], self.k.dtype, pshape)
                              for f in frames[:n]], dim=1)
        dest = torch.as_tensor(self._lane_pages[slot][:n], dtype=torch.long,
                               device=self.device)
        if meta.get("scales"):
            if self.k_scale is None:
                raise PageStateError("handoff carries scales but pool is not int8")
            sshape = (self.n_layers, self.n_heads, 1, 1)
            shalf = 4 * math.prod(sshape)
            sbuf = frames[n]
            if len(sbuf) != 2 * shalf:
                raise PageStateError(f"scales frame carries {len(sbuf)} bytes, the "
                                     f"pool's scales need {2 * shalf}")
            self.k_scale[:, slot] = _from_bytes(sbuf[:shalf], torch.float32,
                                                sshape).to(self.device)
            self.v_scale[:, slot] = _from_bytes(sbuf[shalf:], torch.float32,
                                                sshape).to(self.device)
        self.k[:, dest] = lane_k.to(self.device)
        self.v[:, dest] = lane_v.to(self.device)
        self.positions[slot] = position
        if handoff_key is not None:
            self._handoff_keys[handoff_key] = slot
            self._slot_handoff_key[slot] = handoff_key
        return True

    def handoff_slot(self, handoff_key):
        """Slot currently holding ``handoff_key``, or None."""
        return self._handoff_keys.get(handoff_key)

    def advance(self, slot):
        """Bump a slot's position after a decode step wrote its token
        (clamped at the last cache index)."""
        self.positions[slot] = min(self.positions[slot] + 1, self.max_seq_len - 1)

    # -- stats ----------------------------------------------------------
    def nbytes(self):
        """Device bytes held by the KV storage (+ scales in int8 mode)."""
        total = (self.k.numel() * self.k.element_size()
                 + self.v.numel() * self.v.element_size())
        if self.k_scale is not None:
            total += 2 * self.k_scale.numel() * self.k_scale.element_size()
        return int(total)

    def occupancy(self):
        in_use = self.slots_in_use
        covered = self.pages_in_use * self.page_tokens
        cached = int(self.positions.sum())
        return {
            "max_slots": self.max_slots,
            "in_use": in_use,
            "free": self.free_slots,
            "utilization": in_use / self.max_slots,
            "allocations": self.allocations,
            "frees": self.frees,
            "peak_in_use": self.peak_in_use,
            "cached_tokens": cached,
            "kv_cache_dtype": self.kv_cache_dtype,
            "pool_bytes": self.nbytes(),
            "page_tokens": self.page_tokens,
            "pages_total": self.n_data_pages,
            "pages_in_use": self.pages_in_use,
            "pages_free": self.free_pages,
            "peak_pages_in_use": self.peak_pages_in_use,
            "page_fragmentation": (covered - cached) / max(covered, 1),
        }


# -- host entry frames (the prefix cache's spill tier) -----------------------
# storage dtype <-> the name numpy (with ml_dtypes for bf16) gives it
_DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
                torch.float16: "float16", torch.int8: "int8"}
_NAMED_DTYPES = {name: dt for dt, name in _DTYPE_NAMES.items()}


def _raw_bytes(t):
    return t.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()


def _from_bytes(frame, dtype, shape):
    flat = torch.frombuffer(bytearray(frame), dtype=torch.uint8)
    return flat.view(dtype).reshape(shape)


def export_entry_frames(k, v, k_scale=None, v_scale=None):
    """Serialize a host-side KV entry (a ``[L, nh, P, hd]`` pair of CPU
    tensors in its storage dtype, fp32/bf16/fp16/int8, plus optional
    per-(layer, head) fp32 scales) into ``(meta, frames)``: raw ``bytes``
    payloads and the meta dict ``import_entry_frames`` needs to rebuild the
    tensors bit for bit."""
    meta = {
        "dtype": _DTYPE_NAMES[k.dtype],
        "shape": list(k.shape),
        "scales": k_scale is not None,
    }
    frames = [_raw_bytes(k), _raw_bytes(v)]
    if k_scale is not None:
        meta["scale_shape"] = list(k_scale.shape)
        frames.append(_raw_bytes(k_scale.float()))
        frames.append(_raw_bytes(v_scale.float()))
    return meta, frames


def import_entry_frames(meta, frames):
    """Inverse of ``export_entry_frames``: ``(k, v, k_scale, v_scale)`` as
    CPU tensors. Raises ValueError when a frame's byte count disagrees with
    the advertised shape and dtype, or the dtype is unknown."""
    name = str(meta["dtype"])
    if name not in _NAMED_DTYPES:
        raise ValueError(f"entry frame dtype {name!r} is not one of {sorted(_NAMED_DTYPES)}")
    dtype = _NAMED_DTYPES[name]
    shape = tuple(int(d) for d in meta["shape"])
    expect = torch.empty(0, dtype=dtype).element_size() * math.prod(shape)
    if len(frames[0]) != expect or len(frames[1]) != expect:
        raise ValueError(
            f"entry frame carries {len(frames[0])}/{len(frames[1])} bytes "
            f"but shape {shape} x {name} needs {expect}")
    k = _from_bytes(frames[0], dtype, shape)
    v = _from_bytes(frames[1], dtype, shape)
    k_scale = v_scale = None
    if meta.get("scales"):
        sshape = tuple(int(d) for d in meta["scale_shape"])
        sexpect = 4 * math.prod(sshape)
        if len(frames[2]) != sexpect or len(frames[3]) != sexpect:
            raise ValueError(
                f"scale frame carries {len(frames[2])}/{len(frames[3])} "
                f"bytes but shape {sshape} x float32 needs {sexpect}")
        k_scale = _from_bytes(frames[2], torch.float32, sshape)
        v_scale = _from_bytes(frames[3], torch.float32, sshape)
    return k, v, k_scale, v_scale
