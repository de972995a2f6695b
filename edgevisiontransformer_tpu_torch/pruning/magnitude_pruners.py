"""Standalone magnitude pruners: the pytorch_prune ports (port of
``edgevisiontransformer_tpu/pruning/magnitude_pruners.py``; the mask
builders are a copy of its numpy code, so the masks are the same bits).

Pure-numpy mask builders mirroring deit_pruning/src/pytorch_prune/:

* ``block_prune_mask``: topk of per-block norms, lowest blocks zeroed
  (block.py:11-75 BlockPruningMethod).
* ``ln_smart_structured_mask``: auto row-vs-col structured pruning: compare
  the normalized bottom-k row-norm sum against the bottom-k col-norm sum and
  prune along the weaker dimension (ln_smart.py:11-66 LnSmartStructured).
* ``ln_structured_mask`` / ``l1_unstructured_mask`` / ``random_*``: the
  torch.nn.utils.prune functions the pruner CLI accepts (pruner.py:85-103).
* ``hybrid_prune_params``: the hybrid recipe, block pruning on attention
  matrices, ln_smart on FFN denses (pruner.py:85-103), over a tree of
  tensors.

All masks are computed in torch orientation [out, in]; the port's kernels
keep the Flax layout [in, out], so ``hybrid_prune_params`` transposes around
the mask.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..config import ViTConfig


def _nparams_to_prune(amount, n: int) -> int:
    """torch _compute_nparams_toprune semantics: int = absolute count,
    float in [0,1] = round(amount * n)."""
    if isinstance(amount, int) and not isinstance(amount, bool):
        if not 0 <= amount <= n:
            raise ValueError(f"amount={amount} out of range [0, {n}]")
        return amount
    if not 0.0 <= amount <= 1.0:
        raise ValueError(f"amount={amount} must be a fraction in [0, 1]")
    return int(round(amount * n))


def _norm(a: np.ndarray, ord, axis):
    a = np.asarray(a, np.float64)  # rank stability near the prune cutoff
    if ord == "fro":
        return np.sqrt(np.sum(a * a, axis=axis))
    return np.linalg.norm(a, ord=ord, axis=axis)


def block_prune_mask(
    w: np.ndarray, amount, block_row: int, block_col: int, ord="fro"
) -> np.ndarray:
    """[out, in] elementwise mask zeroing the lowest-norm blocks."""
    rows, cols = w.shape
    assert rows % block_row == 0 and cols % block_col == 0, (
        f"{w.shape} not divisible by block ({block_row}, {block_col})")
    brows, bcols = rows // block_row, cols // block_col
    blocks = w.reshape(brows, block_row, bcols, block_col).transpose(0, 2, 1, 3)
    norms = np.sqrt(np.sum(blocks * blocks, axis=(2, 3))) if ord == "fro" else \
        _norm(blocks.reshape(brows, bcols, -1), ord, axis=-1)
    n = _nparams_to_prune(amount, brows * bcols)
    mask = np.ones((brows, bcols), w.dtype)
    if n:
        idx = np.argsort(norms.ravel(), kind="stable")[:n]
        mask.ravel()[idx] = 0
    return np.repeat(np.repeat(mask, block_row, axis=0), block_col, axis=1)


def ln_smart_structured_mask(w: np.ndarray, amount, ord: int = 1) -> np.ndarray:
    """[out, in] mask: decide row-vs-col by comparing normalized bottom-k norm
    sums, then zero the lowest-norm rows or cols (ln_smart.py:35-62)."""
    rows, cols = w.shape
    k_test = _nparams_to_prune(amount, min(rows, cols))
    row_norms = _norm(w, ord, axis=1)
    col_norms = _norm(w, ord, axis=0)
    # normalize by the other dim's length so row/col sums are comparable
    row_sum = np.sort(row_norms)[:k_test].sum() / (cols ** (1.0 / ord))
    col_sum = np.sort(col_norms)[:k_test].sum() / (rows ** (1.0 / ord))
    prune_row = col_sum >= row_sum

    n = _nparams_to_prune(amount, rows if prune_row else cols)
    mask = np.ones_like(w)
    if n:
        # Reference quirk: the selection norm is always L2 — ln_smart.py:57
        # calls torch.linalg.norm without ord — even when the row/col
        # decision above used self.ord.
        norms = _norm(w, 2, axis=1 if prune_row else 0)
        idx = np.argsort(norms, kind="stable")[:n]
        if prune_row:
            mask[idx, :] = 0
        else:
            mask[:, idx] = 0
    return mask


def ln_structured_mask(w: np.ndarray, amount, dim: int, ord: int = 1) -> np.ndarray:
    """torch prune.ln_structured: zero lowest-norm slices along ``dim``."""
    n = _nparams_to_prune(amount, w.shape[dim])
    norms = _norm(w, ord, axis=1 - dim)
    mask = np.ones_like(w)
    if n:
        idx = np.argsort(norms, kind="stable")[:n]
        if dim == 0:
            mask[idx, :] = 0
        else:
            mask[:, idx] = 0
    return mask


def l1_unstructured_mask(w: np.ndarray, amount) -> np.ndarray:
    n = _nparams_to_prune(amount, w.size)
    mask = np.ones_like(w)
    if n:
        idx = np.argsort(np.abs(w).ravel(), kind="stable")[:n]
        mask.ravel()[idx] = 0
    return mask


def random_unstructured_mask(w: np.ndarray, amount, seed: int = 0) -> np.ndarray:
    n = _nparams_to_prune(amount, w.size)
    mask = np.ones_like(w)
    if n:
        idx = np.random.RandomState(seed).permutation(w.size)[:n]
        mask.ravel()[idx] = 0
    return mask


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def hybrid_prune_params(
    cfg: ViTConfig,
    params: Dict,
    amount: float,
    block_row: Optional[int] = None,
    block_col: Optional[int] = None,
    ln_ord: int = 1,
) -> Dict:
    """The hybrid pruner (pruner.py:85-103): block-magnitude pruning on the
    attention matrices (block = one head's rows by default), LnSmart on the
    FFN denses.  Returns a masked copy of the params (zeros in place; compile
    to static shapes separately via the movement engine if desired).  The
    masks are built in numpy on the host, and each pruned matrix goes back
    to its tensor's device and dtype."""
    had_wrapper = "params" in params
    p = dict(params["params"] if had_wrapper else params)
    br = block_row if block_row is not None else cfg.resolved_head_dim
    bc = block_col if block_col is not None else cfg.dim

    def back(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(like.device, like.dtype)

    for i in range(cfg.depth):
        blk = dict(p[f"block_{i}"])
        attn = dict(blk["attn"])
        ffn = dict(blk["ffn"])
        heads = cfg.layer_heads(i)
        hd = cfg.resolved_head_dim

        # qkv fused [in=dim, out=3*H*hd]: prune q/k/v separately like the
        # reference's per-Linear loop, in torch [out, in] orientation.
        qkv = _np(attn["qkv_kernel"])
        parts = []
        for j in range(3):
            wj = qkv[:, j * heads * hd:(j + 1) * heads * hd].T  # [out, in]
            parts.append(wj * block_prune_mask(wj, amount, br, min(bc, wj.shape[1])))
        attn["qkv_kernel"] = back(np.concatenate([w.T for w in parts], axis=1),
                                  attn["qkv_kernel"])
        out_w = _np(attn["out_kernel"]).T  # [out=dim, in=H*hd]
        out_m = block_prune_mask(out_w, amount, min(br, out_w.shape[0]),
                                 min(bc, out_w.shape[1]))
        attn["out_kernel"] = back((out_w * out_m).T, attn["qkv_kernel"])

        for name in ("fc1_kernel", "fc2_kernel"):
            w = _np(ffn[name]).T  # [out, in]
            m = ln_smart_structured_mask(w, amount, ord=ln_ord)
            ffn[name] = back((w * m).T, ffn[name])

        blk["attn"] = attn
        blk["ffn"] = ffn
        p[f"block_{i}"] = blk
    return {"params": p} if had_wrapper else p
