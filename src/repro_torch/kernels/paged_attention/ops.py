"""Public op: coalesced paged decode attention.

``paged_attention`` = one class-k pass per class in ``K ∪ {0}`` + the exact
merge of their partial softmax states (:func:`merge_partials`).
``K_classes = ()`` gives the page-granular baseline (one descriptor per
page); ``K_classes = (k1, k2, ...)`` adds coalesced classes chosen by
Algorithm 3 (``repro_torch.kvcache.block_table.choose_kernel_classes``).

Descriptor tables (window index + class assignment per 2^k window) are
host numpy (the serving engine computes them when block tables change).
:func:`prepare_descriptors` checks them on the host against the pool and
uploads them once, so one decode step checks and uploads once for all its
layers.

:func:`paged_attention_class_pass` dispatches on the device of ``q``: CPU
tensors run the plain version (:func:`.ref.paged_attention_class_pass_ref`),
CUDA tensors launch the CUDA kernels (``csrc/paged_attention.cu``) or raise —
there is no fallback from one to the other.  On the card a class pass splits
each row's windows over ``n_split`` blocks (:func:`choose_splits`) and one C
call launches two kernels on the stream: the split kernel, writing partial
states into a scratch the wrapper allocates, and the combine kernel, which
merges them into the pass's ``(o, m, l)``.  ``LAUNCHES["paged_attention"]``
counts the wrapper's class passes (two device kernels each),
``CLASS_LAUNCHES[k]`` those of class k, and ``CLASS_GRIDS[k]`` holds the
split kernel's grids ``(KVH, B, n_split)`` that class k launched.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from ...kvcache.block_table import descriptor_tables, dma_descriptor_count
from .ref import paged_attention_class_pass_ref

#: kernel launches so far (plain-version runs not counted)
LAUNCHES: Dict[str, int] = {"paged_attention": 0}
#: kernel launches so far, by class k
CLASS_LAUNCHES: Dict[int, int] = {}
#: the split kernel's grids (KVH, B, n_split) launched so far, by class k
CLASS_GRIDS: Dict[int, Set[Tuple[int, int, int]]] = {}
HEAD_DIMS = (32, 64, 128, 256)      # the kernel's instantiations (D)
GMAX = 8                            # its most query rows per KV head
#: streaming multiprocessors :func:`choose_splits` plans for when it is
#: not told the card's count (an H100 SXM's)
SMS = 132
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def reset_launch_counts() -> None:
    LAUNCHES["paged_attention"] = 0
    CLASS_LAUNCHES.clear()
    CLASS_GRIDS.clear()


def build_descriptors(block_tables: np.ndarray, K_classes: Sequence[int]
                      ) -> Dict[int, Tuple[np.ndarray, np.ndarray]]:
    """Host-side: class-k window tables for the kernel (scheduler-time)."""
    return descriptor_tables(np.asarray(block_tables), K_classes)


def dma_stats(block_tables: np.ndarray, K_classes: Sequence[int]
              ) -> Dict[str, float]:
    """Descriptor-count reduction (the paper's miss metric, paged-KV
    edition)."""
    return dma_descriptor_count(np.asarray(block_tables), K_classes)


def choose_splits(B: int, KVH: int, n_win: int, sms: int = SMS) -> int:
    """How many blocks split a class pass's windows per (row, KV head):
    enough that the ``(KVH, B, n_split)`` grid holds at least two blocks
    per SM (``sms`` of them), never more than the ``n_win`` windows (each
    split walks at least one), and 1 when there are none."""
    if n_win <= 0:
        return 1
    return max(1, min(n_win, -(-2 * sms // (B * KVH))))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def classes_of(K_classes: Sequence[int]) -> Tuple[int, ...]:
    """The passes a step runs: ``sorted(K ∪ {0}, reverse=True)``."""
    return tuple(sorted(set(int(k) for k in K_classes) | {0}, reverse=True))


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError("paged_attention: " + msg)


def check_descriptor(win_idx, covered, n_pages: int, k: int) -> None:
    """Host check of one class's tables against a pool of ``n_pages``: the
    CUDA kernel reads window ``win_idx[b, j]`` wherever ``covered[b, j]``,
    with no clamp, so every such index must lie in the pool."""
    wi, cov = np.asarray(win_idx), np.asarray(covered)
    P2 = 1 << k
    _check(n_pages % P2 == 0,
           f"{n_pages} pool pages do not split into class-{k} windows")
    _check(wi.ndim == 2 and wi.shape == cov.shape,
           f"class {k}: win_idx {wi.shape} and covered {cov.shape} must "
           "be one [B, n_win] shape")
    live = wi[cov != 0]
    _check(live.size == 0 or (int(live.min()) >= 0
                              and int(live.max()) < n_pages // P2),
           f"class {k}: a covered window index lies outside the "
           f"{n_pages // P2} windows of the pool")


@dataclasses.dataclass
class PreparedDescriptors:
    """Checked descriptor tables of one batch, on one device:
    ``tables[k] = (win_idx int32 [B, n_win], covered int8 [B, n_win])``."""
    classes: Tuple[int, ...]
    tables: Dict[int, Tuple[torch.Tensor, torch.Tensor]]
    n_pages: int


def prepare_descriptors(descriptors: Dict[int, Tuple[np.ndarray,
                                                     np.ndarray]],
                        classes: Sequence[int], n_pages: int,
                        device) -> PreparedDescriptors:
    """Check every class's host tables against a pool of ``n_pages`` and
    upload them to ``device``."""
    tables = {}
    for k in classes:
        wi, cov = descriptors[k]
        check_descriptor(wi, cov, n_pages, k)
        tables[k] = (
            torch.from_numpy(np.ascontiguousarray(wi, np.int32)).to(device),
            torch.from_numpy(np.ascontiguousarray(cov, np.int8)).to(device))
    return PreparedDescriptors(tuple(classes), tables, n_pages)


def _launch(q, k_pool, v_pool, win_idx, covered, kv_lens, k, page_size,
            scale, n_split=None):
    """Launch the class-k kernels on checked CUDA tensors, the windows split
    ``n_split`` ways (default :func:`choose_splits` for the card's SM
    count); returns (o, m, l)."""
    from . import _build

    P2 = 1 << k
    B, H, D = q.shape
    n_pages, T, KVH, D2 = k_pool.shape
    dev = q.device
    tensors = (q, k_pool, v_pool, win_idx, covered, kv_lens)
    _check(all(t.device == dev for t in tensors),
           "every tensor must lie on one CUDA device")
    _check(all(t.is_contiguous() for t in tensors),
           "every tensor must be contiguous")
    _check(q.dtype in _DTYPE_CODE and k_pool.dtype == q.dtype
           and v_pool.dtype == q.dtype,
           f"q and the pools must share one dtype of {list(_DTYPE_CODE)}; "
           f"got {q.dtype}, {k_pool.dtype}, {v_pool.dtype}")
    _check(v_pool.shape == k_pool.shape and D2 == D,
           "pools must be [n_pages, T, KVH, D] with q's head dim")
    _check(T == page_size, f"pool pages hold {T} tokens, not {page_size}")
    _check(B >= 1 and H % KVH == 0 and H // KVH <= GMAX,
           f"H={H} must be a multiple of KVH={KVH}, at most {GMAX}x")
    _check(D in HEAD_DIMS, f"head dim {D} not in {HEAD_DIMS}")
    _check(k_pool.data_ptr() % 16 == 0 and v_pool.data_ptr() % 16 == 0,
           "the pools must start on a 16-byte boundary (the kernel copies "
           "K/V rows 16 bytes at a time)")
    _check(win_idx.dtype == torch.int32 and covered.dtype == torch.int8
           and kv_lens.dtype == torch.int32,
           "win_idx int32, covered int8 and kv_lens int32 expected")
    n_win = win_idx.shape[1]
    _check(win_idx.shape == (B, n_win) and covered.shape == (B, n_win)
           and kv_lens.shape == (B,), "descriptor tables must be [B, n_win] "
           "and kv_lens [B]")
    n_split = (choose_splits(B, KVH, n_win, _sm_count(dev.index))
               if n_split is None else int(n_split))
    _check(1 <= n_split <= max(n_win, 1),
           f"n_split {n_split} must lie in 1 .. max(n_win, 1) = "
           f"{max(n_win, 1)}")
    lib = _build.load()
    part = torch.empty((n_split, B, H, D + 2), dtype=torch.float32,
                       device=dev)
    o = torch.empty((B, H, D), dtype=torch.float32, device=dev)
    m = torch.empty((B, H), dtype=torch.float32, device=dev)
    l = torch.empty((B, H), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.paged_attention_class_pass(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            win_idx.data_ptr(), covered.data_ptr(), kv_lens.data_ptr(),
            part.data_ptr(), o.data_ptr(), m.data_ptr(), l.data_ptr(), B, H,
            KVH, D, n_win, P2 * T, float(scale), n_split,
            _DTYPE_CODE[q.dtype], stream)
    if rc != 0:
        raise RuntimeError("paged_attention kernel launch failed: "
                           + lib.paged_attention_error_string(rc).decode())
    LAUNCHES["paged_attention"] += 1
    CLASS_LAUNCHES[k] = CLASS_LAUNCHES.get(k, 0) + 1
    CLASS_GRIDS.setdefault(k, set()).add((KVH, B, n_split))
    return o, m, l


def _class_pass(q, k_pool, v_pool, win_idx, covered, kv_lens, k, page_size,
                scale, n_split=None):
    """One class pass on tables already checked by
    :func:`check_descriptor` (tensors on q's device): CPU → plain version,
    CUDA → kernels (windows split ``n_split`` ways) or raise."""
    if q.device.type == "cpu":
        return paged_attention_class_pass_ref(
            q, k_pool, v_pool, win_idx, covered, kv_lens,
            pages_per_block=1 << k, page_size=page_size, scale=scale)
    if q.device.type == "cuda":
        return _launch(q, k_pool, v_pool, win_idx, covered, kv_lens, k,
                       page_size, scale, n_split)
    raise ValueError(f"paged_attention: no implementation for {q.device}")


@torch.no_grad()
def paged_attention_class_pass(
        q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
        win_idx, covered, kv_lens, *, pages_per_block: int, page_size: int,
        scale: Optional[float] = None, n_split: Optional[int] = None
        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One class-k pass (``pages_per_block = 2^k``).

    q: [B, H, D]; pools: [n_pages, T, KVH, D]; win_idx/covered: [B, n_win]
    numpy arrays or tensors (copied to the host for the range check);
    kv_lens: [B].  Returns the unnormalised ``(o [B,H,D] f32, m [B,H] f32,
    l [B,H] f32)`` of :func:`.ref.paged_attention_class_pass_ref`.  On the
    card the windows are split ``n_split`` ways (default
    :func:`choose_splits`), which changes only the order of the f32 sums.
    """
    P2 = int(pages_per_block)
    _check(P2 >= 1 and P2 & (P2 - 1) == 0,
           f"pages_per_block {P2} is not a power of two")
    k = P2.bit_length() - 1
    dev = q.device
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    host = [a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
            for a in (win_idx, covered)]
    check_descriptor(host[0], host[1], k_pool.shape[0], k)
    wi = torch.from_numpy(np.ascontiguousarray(host[0], np.int32)).to(dev)
    cov = torch.from_numpy(np.ascontiguousarray(host[1] != 0, np.int8)
                           ).to(dev)
    lens = torch.as_tensor(kv_lens).to(device=dev, dtype=torch.int32)
    return _class_pass(q, k_pool, v_pool, wi, cov, lens.contiguous(), k,
                       page_size, scale, n_split)


def merge_partials(parts) -> torch.Tensor:
    """Exact merge of per-class (o_unnorm, m, l) partial-softmax states."""
    m_star = torch.stack([p[1] for p in parts]).amax(0)     # [B, H]
    o = 0.0
    lsum = 0.0
    for o_k, m_k, l_k in parts:
        w = torch.exp(m_k - m_star)
        o = o + o_k * w[..., None]
        lsum = lsum + l_k * w
    return o / torch.clamp_min(lsum, 1e-30)[..., None]


@torch.no_grad()
def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, block_tables: Optional[np.ndarray],
                    kv_lens, *, page_size: int, K_classes: Sequence[int] = (),
                    descriptors=None, scale: Optional[float] = None
                    ) -> torch.Tensor:
    """q: [B, H, D] → [B, H, D] decode attention over the paged KV pool.

    ``descriptors`` may be the host tables of :func:`build_descriptors`
    (built from ``block_tables`` when None) or a
    :class:`PreparedDescriptors` already checked against this pool."""
    dev = q.device
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if isinstance(descriptors, PreparedDescriptors):
        prep = descriptors
        _check(prep.n_pages == k_pool.shape[0],
               "descriptors were checked against another pool size")
    else:
        classes = classes_of(K_classes)
        if descriptors is None:
            descriptors = build_descriptors(block_tables, classes)
        prep = prepare_descriptors(descriptors, classes, k_pool.shape[0],
                                   dev)
    lens = torch.as_tensor(kv_lens).to(device=dev, dtype=torch.int32)
    lens = lens.contiguous()
    parts = [_class_pass(q, k_pool, v_pool, *prep.tables[k], lens, k,
                         page_size, scale) for k in prep.classes]
    return merge_partials(parts).to(q.dtype)
