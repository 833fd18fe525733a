"""Ceiling probes: pass 1 of the fused top-k kernels without the selection.

Counterpart of the Pallas ceiling probes in ``scripts/kernel_probe.py``
(``ceiling_parts_1m``, ``ceiling_1m``, ``ceiling_tiled_1m``, ``ceiling_q64``,
``ceiling_q1024``): the fused kernel's tile walk and product with the running
top-k merge replaced by a cheaper stand-in, so that the stages of pass 1 can
be timed one on top of the other. For every query row the result is the sum,
over corpus tiles of ``block_n`` columns, of

========== ==============================================================
``dma``    element ``[0, 0]`` of the tile (the queries are not read)
``mm``     column 0 of ``q @ tile``, unmasked (``matmul`` is an alias)
``mask``   the same with columns at or beyond ``n_valid`` set to ``-inf``
``rowmax`` the masked row maximum
``prologue`` that maximum plus its arg-maximum inside the tile (lowest
           column on a tie) as f32
``mmint``, ``rowmaxint``  int8 only: ``mm`` / ``rowmax`` on the raw int32
           sums (mask value ``-(2**31) + 1``), summed in int32
========== ==============================================================

A float corpus (f32 or bf16, flat ``[D, N]`` or tile-major ``[T, D, block_n]``)
takes f32 or bf16 queries and multiplies the values widened to f32; an int8
corpus takes int8 queries, multiplies in int32 and, outside the two int
stages, converts to f32 and multiplies by the per-column ``scales``.

:func:`ceiling` launches ``csrc/ceiling.cu`` for CUDA tensors and takes
:func:`ceiling_plain` only for CPU tensors. The int stages (and ``dma`` over
int8) are exact; the float stages differ from the plain version by the order
of the sums, inside a dot product and across tiles.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .topk import _KERNEL_TILE_N, _launch_plan, _layout_args, _untile

STAGES = {"dma": 1, "mm": 2, "mask": 3, "rowmax": 4, "prologue": 5, "mmint": 6, "rowmaxint": 7}
INT_STAGES = ("mmint", "rowmaxint")
INT_MASK = -(2**31) + 1


def ladder_stages(corpus_dtype: torch.dtype) -> tuple[str, ...]:
    """The stages that exist over a corpus of this dtype, cheapest first:
    each adds one step of pass 1 to the one before it."""
    if corpus_dtype == torch.int8:
        return ("dma", "mmint", "rowmaxint", "mm", "mask", "rowmax", "prologue")
    return ("dma", "mm", "mask", "rowmax", "prologue")


def is_exact(corpus_dtype: torch.dtype, stage: str) -> bool:
    """Whether the kernel's result is the plain version's bit for bit (integer
    sums) rather than equal up to the order of float sums."""
    return corpus_dtype == torch.int8 and stage in INT_STAGES + ("dma",)


def _stage(stage: str) -> str:
    stage = "mm" if stage == "matmul" else stage
    if stage not in STAGES:
        raise ValueError(f"unknown ceiling stage: {stage}")
    return stage


def _block_n(corpus_t: torch.Tensor, block_n: Optional[int]) -> int:
    if corpus_t.dim() == 3:
        if block_n is not None and block_n != corpus_t.shape[2]:
            raise ValueError("a tile-major corpus is probed at its own block_n")
        return int(corpus_t.shape[2])
    if block_n is None or block_n < 1 or block_n % _KERNEL_TILE_N:
        raise ValueError(f"block_n must be a positive multiple of {_KERNEL_TILE_N}")
    return int(block_n)


def _extent(corpus_t: torch.Tensor, n_valid: Optional[int]) -> tuple[int, int]:
    """(physical columns, mask limit); without ``n_valid`` nothing is masked."""
    if corpus_t.dim() not in (2, 3):
        raise ValueError(f"corpus must be [D, N] or [n_tiles, D, block_n], got {tuple(corpus_t.shape)}")
    n = corpus_t.shape[-1] * (corpus_t.shape[0] if corpus_t.dim() == 3 else 1)
    return n, n if n_valid is None else min(int(n_valid), n)


def _check(queries, corpus_t, stage, scales) -> bool:
    """Validate types; returns whether the corpus is int8."""
    is_int8 = corpus_t.dtype == torch.int8
    if is_int8:
        if queries.dtype != torch.int8:
            raise TypeError("an int8 corpus is probed with int8 queries")
        if stage not in INT_STAGES + ("dma",) and scales is None:
            raise ValueError(f"stage '{stage}' over an int8 corpus needs the column scales")
    else:
        if corpus_t.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"corpus dtype {corpus_t.dtype} is not f32, bf16 or int8")
        if stage in INT_STAGES:
            raise ValueError(f"stage '{stage}' exists only over an int8 corpus")
        if not queries.dtype.is_floating_point:
            raise TypeError("a float corpus is probed with float queries")
    if queries.dim() != 2 or queries.shape[1] != corpus_t.shape[-2]:
        raise ValueError(f"queries {tuple(queries.shape)} do not match corpus {tuple(corpus_t.shape)}")
    return is_int8


def ceiling_plain(
    queries: torch.Tensor,
    corpus_t: torch.Tensor,
    stage: str,
    block_n: Optional[int] = None,
    n_valid: Optional[int] = None,
    scales: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch version of the ceiling kernel, tile by tile (a
    tile-major corpus brings its own ``block_n``). Returns ``[Q]`` f32."""
    stage = _stage(stage)
    is_int8 = _check(queries, corpus_t, stage, scales)
    n, limit = _extent(corpus_t, n_valid)
    bn = _block_n(corpus_t, block_n)
    flat = _untile(corpus_t)
    nq = queries.shape[0]
    int_sum = is_exact(corpus_t.dtype, stage)
    acc = torch.zeros(nq, dtype=torch.int32 if int_sum else torch.float32, device=flat.device)
    sc = None if scales is None else _untile(scales).reshape(-1).float()
    cols = torch.arange(n, device=flat.device)
    for c0 in range(0, n, bn):
        tile = flat[:, c0 : c0 + bn]
        if stage == "dma":
            acc = acc + (tile[0, 0].to(torch.int32) if is_int8 else tile[0, 0].float())
            continue
        if is_int8:
            # Exact int32 sums: an int matmul on the CPU, f64 (exact up to
            # 2^53) where the device has no integer matmul.
            if flat.is_cuda:
                s = (queries.double() @ tile.double()).to(torch.int32)
            else:
                s = queries.to(torch.int32) @ tile.to(torch.int32)
            if stage not in INT_STAGES:
                s = s.float() * sc[c0 : c0 + bn]
        else:
            s = queries.float() @ tile.float()
        low = INT_MASK if stage in INT_STAGES else float("-inf")
        if stage in ("mm", "mmint"):
            acc = acc + s[:, 0]
            continue
        s = torch.where(cols[c0 : c0 + bn] < limit, s, torch.full_like(s, low))
        if stage == "mask":
            acc = acc + s[:, 0]
        elif stage in ("rowmax", "rowmaxint"):
            acc = acc + s.max(dim=1).values
        else:  # prologue; the first maximum is the lowest column
            mx = s.max(dim=1).values
            local = torch.arange(s.shape[1], device=s.device)
            am = torch.where(s == mx[:, None], local, s.shape[1]).min(dim=1).values
            acc = acc + mx + am.float()
    return acc.float()


def fused_chunk_columns(nq: int, n: int, device) -> int:
    """Columns one pass-1 block of the fused kernels walks at ``(nq, n)`` on
    ``device``: probing at this ``block_n`` runs exactly their grid."""
    return _launch_plan(nq, n, 8 if nq <= 8 else 32, device)[0] * _KERNEL_TILE_N


def _plan(nq: int, n: int, tq: int, block_n: int, device) -> tuple[int, int, int]:
    """(tiles per chunk, chunks, kernel tiles per probe tile): the fused
    kernels' grid rule with the chunk cut down to whole probe tiles (one
    probe tile where it is wider than the rule's chunk)."""
    per_chunk, _ = _launch_plan(nq, n, tq, device)
    block_tiles = block_n // _KERNEL_TILE_N
    per_chunk = max(block_tiles, per_chunk // block_tiles * block_tiles)
    n_tiles = -(-n // _KERNEL_TILE_N)
    return per_chunk, -(-n_tiles // per_chunk), block_tiles


def ceiling(
    queries: torch.Tensor,
    corpus_t: torch.Tensor,
    stage: str,
    block_n: Optional[int] = None,
    n_valid: Optional[int] = None,
    scales: Optional[torch.Tensor] = None,
    read_check: bool = False,
):
    """One ceiling stage (see the module docstring); returns ``[Q]`` f32.

    ``read_check=True`` (``dma`` on CUDA only) also returns the XOR of every
    32-bit word the first query tile's blocks loaded, which equals the XOR of
    the corpus widened to 32-bit words if every element was really read."""
    stage = _stage(stage)
    if not corpus_t.is_cuda:
        if read_check:
            raise ValueError("read_check is the CUDA kernel's")
        return ceiling_plain(queries, corpus_t, stage, block_n, n_valid, scales)
    from . import _cuda

    is_int8 = _check(queries, corpus_t, stage, scales)
    if read_check and stage != "dma":
        raise ValueError("read_check belongs to the dma stage")
    if queries.device != corpus_t.device or not corpus_t.is_contiguous():
        raise ValueError("queries and a contiguous corpus must lie on the same CUDA device")
    if corpus_t.dim() == 3 and corpus_t.shape[2] % _KERNEL_TILE_N:
        raise ValueError(f"tile-major block_n must be a multiple of {_KERNEL_TILE_N}")
    n, limit = _extent(corpus_t, n_valid)
    if n >= 2**31:
        raise ValueError("the CUDA ceiling kernel takes at most 2^31 - 1 columns")
    nq, d = queries.shape
    if is_int8:
        if d % 4:
            raise ValueError("the int8 kernel needs D to be a multiple of 4")
        q = queries.contiguous()
        if scales is not None:
            if scales.dtype != torch.float32 or scales.device != corpus_t.device:
                raise TypeError("scales must be f32 on the corpus's device")
            if not scales.is_contiguous() or scales.numel() != n:
                raise ValueError("scales must be contiguous, one per column")
    else:
        q = queries.float().contiguous()
    out = torch.empty(nq, dtype=torch.float32, device=q.device)
    if nq == 0 or n == 0:
        return (out.zero_(), 0) if read_check else out.zero_()
    tq = 8 if nq <= 8 else 32
    per_chunk, chunks, block_tiles = _plan(nq, n, tq, _block_n(corpus_t, block_n), q.device)
    int_partials = is_exact(corpus_t.dtype, stage)
    part = torch.empty(
        (chunks, nq), dtype=torch.int32 if int_partials else torch.float32, device=q.device
    )
    q_tiles = -(-nq // tq)
    sink = (
        torch.empty((chunks, q_tiles, 256), dtype=torch.int32, device=q.device)
        if read_check else None
    )
    ld, tile_stride, bn = _layout_args(corpus_t, n)
    dtype_code = 2 if is_int8 else int(corpus_t.dtype == torch.bfloat16)
    err = _cuda.kernel("ceiling")(
        q.data_ptr(), nq, d, corpus_t.data_ptr(),
        scales.data_ptr() if scales is not None else None,
        dtype_code, STAGES[stage], ld, tile_stride, bn, n, limit, tq, per_chunk, chunks,
        block_tiles, int(int_partials),
        None if int_partials else part.data_ptr(), part.data_ptr() if int_partials else None,
        sink.data_ptr() if sink is not None else None, out.data_ptr(),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _cuda.check(err, "ceiling")
    ceiling.launches += 1
    if not read_check:
        return out
    words = sink[:, 0].reshape(-1).cpu().numpy().view("uint32")
    return out, int(np.bitwise_xor.reduce(words))


ceiling.launches = 0


def corpus_xor(corpus_t: torch.Tensor) -> int:
    """XOR of a corpus as the ``dma`` stage's loads see it: f32 words as they
    are, bf16 values widened to f32, int8 bytes packed four consecutive
    columns of a row to a word. What ``read_check`` must return."""
    flat = _untile(corpus_t).contiguous().cpu()
    if flat.dtype == torch.int8:
        d, n = flat.shape
        pad = -n % 4
        if pad:
            flat = torch.nn.functional.pad(flat, (0, pad))
        words = flat.numpy().view("uint32")
    elif flat.dtype == torch.bfloat16:
        words = flat.view(torch.int16).numpy().view("uint16").astype("uint32") << 16
    else:
        words = flat.numpy().view("uint32")
    return int(np.bitwise_xor.reduce(words.reshape(-1)))
