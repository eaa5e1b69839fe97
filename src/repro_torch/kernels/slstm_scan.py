"""Thin wrappers around the CUDA sLSTM scan kernels (``csrc/slstm_scan.cu``).

Counterpart of ``repro/kernels/slstm_scan.py``: :func:`slstm_scan` is K8,
for ``slstm_scan_call`` — the sLSTM recurrence over a whole sequence with
the four states kept on chip, in the model's head-major layout with the
per-head ``wr (H, hd, 4·hd)`` (the TPU kernel's gate-major permutation and
block-diagonal ``expand_blockdiag`` are not carried over).  The kernel runs
one thread-block cluster per (row tile, head) that holds the head's ``wr``
in its blocks' shared memory; :func:`plan` picks the cluster size.  The
wrapper takes CUDA tensors only, checks them, allocates the outputs,
launches on PyTorch's current stream, raises if the launch failed and adds
one to its ``launches`` count (and its work to the active counters,
``kernels/cost.py``).  A tensor that needs a gradient is refused:
the gradient goes through ``ops._SLSTMScan``, whose forward is K8 with
``save=True`` (each step's gates and states kept for the backward) and
whose backward is :func:`slstm_scan_backward`, K9: the reverse-time scan
that the reference gets from autodiff of ``lax.scan``
(``repro/models/xlstm.py:230``), in the same cluster shape with the roles
of ``wr``'s rows and columns swapped (its own plan,
``plan(..., backward=True)``, and its rows a cluster, :func:`bwd_rows`).
A K9 step is latency: it holds ``wr``'s rows in registers where the block
allows (:func:`bwd_wr_in_registers`), recomputes the forward's step
before it waits for the exchanged gradient, and spreads each row's sends
over the lanes of its unit (the notes in ``csrc/slstm_scan.cu`` give the
levers and their times).  The front door that routes a CPU tensor to the
plain version is ``kernels/ops.py``.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch

from . import _build, cost
from .neighbor_agg import _raise_on, _stream

__all__ = ["slstm_scan", "slstm_scan_backward", "plan", "cluster_sizes",
           "smem_bytes", "bwd_wr_in_registers", "bwd_rows", "cluster_probe",
           "MAX_HEAD_DIM", "MAX_BT", "MAX_UNITS", "CLUSTER_SIZES",
           "SMEM_LIMIT", "reset_launch_counts", "launch_counts"]

MAX_HEAD_DIM = 256    # the kernel's instances: hd 1..256
MAX_BT = 8            # batch rows a cluster
CLUSTER_SIZES = (1, 2, 4, 8)   # the kernel's cluster sizes, smallest first
SMEM_LIMIT = 232_448  # an H100 block's opt-in shared memory (227 KB)
K_SPLIT = 8           # csrc kSplit: threads a unit (its k range split)
MAX_UNITS = 48        # csrc kMaxUnits: units a block (384 threads)
XP_STAGES = 4         # csrc kStages: the xp ring's slots
BWD_REG_HDK = 256     # csrc kBwdRegHdk: K9 holds wr's rows in registers up
BWD_REG_THREADS = 256  # to this padded hd, in blocks of at most this many
SMS_PER_CLUSTER = 16  # K9's rows rule: at most one cluster a 16 SMs
UNITS_PER_BLOCK = 16  # the plan's aim: at most this many units a block


def _bt_instance(bt: int) -> int:
    """The kernel instance that runs ``bt`` rows: 1, 2, 4 or 8."""
    return next(n for n in (1, 2, 4, 8) if bt <= n)


def bwd_wr_in_registers(hd: int, cluster: int) -> bool:
    """Whether K9 holds a block's rows of wr in registers at (hd, cluster)
    (csrc ``bwd_layout``'s ``w_regs``): hd padded to a multiple of
    4·K_SPLIT at most ``BWD_REG_HDK`` and at most ``BWD_REG_THREADS``
    threads a block; else in shared memory."""
    units = -(-hd // cluster)
    threads = -(-K_SPLIT * units // 32) * 32
    hdk = -(-hd // (4 * K_SPLIT)) * 4 * K_SPLIT
    return hdk <= BWD_REG_HDK and threads <= BWD_REG_THREADS


def smem_bytes(hd: int, bt: int, cluster: int,
               backward: bool = False) -> int:
    """Shared memory a block uses at (hd, bt, cluster).  K8: h twice, the
    block's slice of wr and the xp ring, in fp32, with k padded to a
    multiple of 4·K_SPLIT, and two mbarriers (the kernel's ``layout``;
    ``mgg_slstm_smem_bytes`` gives the same number).  K9 (``backward``):
    dg twice (4 floats a padded unit a row), the block's rows of wr unless
    they are in registers (:func:`bwd_wr_in_registers`) and two mbarriers
    (``bwd_layout``, ``mgg_slstm_bwd_smem_bytes``)."""
    bt_i = _bt_instance(bt)
    units = -(-hd // cluster)
    threads = -(-K_SPLIT * units // 32) * 32
    hdk = -(-hd // (4 * K_SPLIT)) * 4 * K_SPLIT
    if backward:
        wr = 0 if bwd_wr_in_registers(hd, cluster) else \
            hdk // K_SPLIT * 4 * threads
        return 4 * (2 * bt_i * 4 * hdk + wr + 4)
    floats = (2 * bt_i * hdk + hdk // (4 * K_SPLIT) * 16 * threads
              + XP_STAGES * bt_i * 4 * units + 4)
    return 4 * floats


def cluster_sizes(hd: int, bt: int, backward: bool = False) -> list:
    """The cluster sizes K8 (K9 with ``backward``) can run at (hd, bt):
    every block holds at least one unit (the kernels' exchange needs every
    block to send) and at most ``MAX_UNITS``, and fits ``SMEM_LIMIT``."""
    return [c for c in CLUSTER_SIZES
            if (c - 1) * -(-hd // c) < hd and -(-hd // c) <= MAX_UNITS
            and smem_bytes(hd, bt, c, backward) <= SMEM_LIMIT]


def bwd_rows(batch: int, heads: int, sms: int) -> int:
    """K9's rows a cluster for ``batch`` rows of ``heads`` heads on a card
    of ``sms`` SMs: the fewest (1..MAX_BT) that keep the clusters, ceil(batch
    / rows) · heads, at most ``sms // SMS_PER_CLUSTER`` (8 on an H100: about
    one a GPC), else MAX_BT.  A step's product sums every row of the
    cluster, so fewer rows a cluster is a shorter step (most of the gain;
    the smaller exchange is the rest); past that many clusters the card ran
    slower, for a cause not measured (PERF.md §6 times 1, 2, 4 and 8 rows a
    cluster at B 2 and B 8, with and without the product).  The rows do
    not change the result."""
    cap = max(1, sms // SMS_PER_CLUSTER)
    return next((bt for bt in range(1, MAX_BT + 1)
                 if -(-batch // bt) * heads <= cap), MAX_BT)


@functools.lru_cache(maxsize=None)
def plan(hd: int, bt: int, backward: bool = False) -> Tuple[int, int]:
    """(cluster size, shared-memory bytes a block) of K8 (K9 with
    ``backward``) for head_dim ``hd`` at ``bt`` rows a cluster: of
    :func:`cluster_sizes` of two blocks or more, the smallest that leaves
    a block at most ``UNITS_PER_BLOCK`` units, else the largest; a cluster
    of one block only where no larger one gives every block a unit (hd 1).
    A block's step is its share of the product out of shared memory, so
    fewer units a block is faster (PERF.md §6 times 2, 4 and 8 blocks at
    hd 32 to 256).  Raises ValueError when no size fits."""
    if hd < 1 or not 1 <= bt <= MAX_BT:
        raise ValueError(f"sLSTM scan: head_dim {hd} or bt {bt} out of range")
    fits = cluster_sizes(hd, bt, backward)
    if not fits:
        c = CLUSTER_SIZES[-1]
        raise ValueError(
            f"sLSTM scan: head_dim {hd} at bt {bt} fits no portable cluster "
            f"({c} blocks hold {-(-hd // c)} units of at most {MAX_UNITS} "
            f"and need {smem_bytes(hd, bt, c, backward)} bytes of shared "
            f"memory a block, the limit is {SMEM_LIMIT})")
    fits = [c for c in fits if c > 1] or fits
    c = next((c for c in fits if -(-hd // c) <= UNITS_PER_BLOCK), fits[-1])
    return c, smem_bytes(hd, bt, c, backward)


def _check(name: str, t: torch.Tensor, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} has dtype {t.dtype}, expected float32")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.requires_grad:
        raise ValueError(f"{name} requires a gradient: the sLSTM scan "
                         "kernels are forward only (the gradient goes "
                         "through ops.slstm_scan)")


def _shape_checks(xp_like: torch.Tensor, wr: torch.Tensor, bt: int) -> int:
    """The checks both wrappers share; returns ``bt`` cut to the batch."""
    if xp_like.device.type != "cuda":
        raise ValueError(f"CUDA kernel called on a {xp_like.device} tensor")
    if wr.dim() != 3:
        raise ValueError(f"wr {tuple(wr.shape)}: expected (H, hd, 4·hd)")
    hd = wr.shape[1]
    if not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim {hd} not in 1..{MAX_HEAD_DIM}")
    if not 1 <= bt <= MAX_BT:
        raise ValueError(f"bt {bt} not in 1..{MAX_BT}")
    return min(bt, max(xp_like.shape[0], 1))


def slstm_scan(xp: torch.Tensor, wr: torch.Tensor,
               state: Dict[str, torch.Tensor], *, bt: int = MAX_BT,
               save: bool = False):
    """K8: the sLSTM recurrence over xp ``(B, S, 4·D)`` fp32 (head-major:
    ``reshape(B, S, H, 4·hd)``, each head ``[z | i | f | o]``) with the
    recurrent weights wr ``(H, hd, 4·hd)`` fp32, from ``state`` h/c/n/m
    ``(B, H, hd)`` fp32 → (hs ``(B, S, H, hd)`` fp32, the states after the
    last step).  ``bt`` batch rows share a cluster (and its copy of wr);
    the result does not depend on it.  With ``save`` it returns a third
    item, what K9 reads: ``g`` ``(B, S, H, hd, 4)``, each step's gate
    pre-activations z, i, f, o a unit, and ``c``, ``n``, ``m`` ``(B, S, H,
    hd)``, the states after each step; hs and the states are the same bits
    as without it."""
    if xp.dim() != 3:
        raise ValueError(f"xp {tuple(xp.shape)}: expected (B, S, 4·D)")
    bt = _shape_checks(xp, wr, bt)
    return _launch(xp, wr, state, bt, plan(wr.shape[1], bt)[0], save)


def _launch(xp, wr, state, bt: int, cluster: int, save: bool = False):
    """One launch of K8 at ``cluster`` blocks a cluster (the plan's, or
    another portable size that fits, to time one against the other)."""
    heads, hd = wr.shape[0], wr.shape[1]
    b, s = xp.shape[0], xp.shape[1]
    dev = xp.device
    _check("xp", xp, (b, s, heads * 4 * hd), dev)
    _check("wr", wr, (heads, hd, 4 * hd), dev)
    for k in ("h", "c", "n", "m"):
        _check(f"state[{k!r}]", state[k], (b, heads, hd), dev)
    hs = torch.empty((b, s, heads, hd), dtype=torch.float32, device=dev)
    new = dict(zip("hcnm", torch.empty((4, b, heads, hd),
                                       dtype=torch.float32, device=dev)))
    saved = None
    if save:
        saved = dict(g=torch.empty((b, s, heads, hd, 4), dtype=torch.float32,
                                   device=dev),
                     **dict(zip("cnm", torch.empty(
                         (3, b, s, heads, hd), dtype=torch.float32,
                         device=dev))))
    ptrs = [saved[k].data_ptr() for k in "gcnm"] if save else [None] * 4
    rc = _build.library("slstm_scan").mgg_slstm_scan(
        xp.data_ptr(), wr.data_ptr(), *(state[k].data_ptr() for k in "hcnm"),
        hs.data_ptr(), *(new[k].data_ptr() for k in "hcnm"), *ptrs, b, s,
        heads, hd, bt, cluster, _stream(dev))
    if rc:
        placed = "; no such cluster fits on this card" if rc == 701 else ""
        _raise_on(rc, f"slstm_scan (a cluster of {cluster} blocks, "
                      f"{smem_bytes(hd, bt, cluster)} bytes of shared "
                      f"memory each{placed})")
    slstm_scan.launches += 1
    cost.record("slstm_scan", lambda: cost.slstm_scan(b, s, heads, hd,
                                                      save=save))
    return (hs, new, saved) if save else (hs, new)


slstm_scan.launches = 0


def slstm_scan_backward(dhs: torch.Tensor, dstate: Dict[str, torch.Tensor],
                        wr: torch.Tensor, saved: Dict[str, torch.Tensor],
                        state: Dict[str, torch.Tensor], *,
                        bt: Optional[int] = None
                        ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """K9: the sLSTM scan's backward.  ``dhs`` ``(B, S, H, hd)`` the
    gradient of hs, ``dstate`` h/c/n/m ``(B, H, hd)`` of the states after
    the last step, ``wr`` ``(H, hd, 4·hd)``, ``saved`` what
    ``slstm_scan(..., save=True)`` returned, ``state`` c/n/m ``(B, H, hd)``
    the states before the first step; all fp32 → (dxp ``(B, S, H·4·hd)``,
    the gradients h/c/n/m of the states before the first step).  The
    gradient of wr is ``Σ_{b,t} h_{t-1}ᵀ · dxp[b, t]``, a product the
    caller runs (``ops._SLSTMScan``).  ``bt`` rows share a cluster
    (None: :func:`bwd_rows` for this card); it does not change the
    result."""
    if dhs.dim() != 4:
        raise ValueError(f"dhs {tuple(dhs.shape)}: expected (B, S, H, hd)")
    if bt is None and dhs.device.type == "cuda":
        bt = bwd_rows(dhs.shape[0], dhs.shape[2], torch.cuda.
                      get_device_properties(dhs.device).multi_processor_count)
    bt = _shape_checks(dhs, wr, MAX_BT if bt is None else bt)
    return _launch_backward(dhs, dstate, wr, saved, state, bt,
                            plan(wr.shape[1], bt, backward=True)[0])


def _launch_backward(dhs, dstate, wr, saved, state, bt: int, cluster: int):
    """One launch of K9 at ``cluster`` blocks a cluster."""
    heads, hd = wr.shape[0], wr.shape[1]
    b, s = dhs.shape[0], dhs.shape[1]
    dev = dhs.device
    _check("dhs", dhs, (b, s, heads, hd), dev)
    _check("wr", wr, (heads, hd, 4 * hd), dev)
    _check("saved['g']", saved["g"], (b, s, heads, hd, 4), dev)
    for k in "cnm":
        _check(f"saved[{k!r}]", saved[k], (b, s, heads, hd), dev)
        _check(f"state[{k!r}]", state[k], (b, heads, hd), dev)
    for k in "hcnm":
        _check(f"dstate[{k!r}]", dstate[k], (b, heads, hd), dev)
    dxp = torch.empty((b, s, heads * 4 * hd), dtype=torch.float32,
                      device=dev)
    d0 = dict(zip("hcnm", torch.empty((4, b, heads, hd),
                                      dtype=torch.float32, device=dev)))
    rc = _build.library("slstm_scan").mgg_slstm_scan_backward(
        dhs.data_ptr(), *(dstate[k].data_ptr() for k in "hcnm"),
        wr.data_ptr(), *(saved[k].data_ptr() for k in "gcnm"),
        *(state[k].data_ptr() for k in "cnm"), dxp.data_ptr(),
        *(d0[k].data_ptr() for k in "hcnm"), b, s, heads, hd, bt, cluster,
        _stream(dev))
    if rc:
        placed = "; no such cluster fits on this card" if rc == 701 else ""
        _raise_on(rc, f"slstm_scan_backward (a cluster of {cluster} blocks, "
                      f"{smem_bytes(hd, bt, cluster, True)} bytes of shared "
                      f"memory each{placed})")
    slstm_scan_backward.launches += 1
    cost.record("slstm_scan_backward",
                lambda: cost.slstm_scan_backward(b, s, heads, hd))
    return dxp, d0


slstm_scan_backward.launches = 0


def cluster_probe(b: int, s: int, heads: int, hd: int, bt: int,
                  cluster: int, device, backward: bool = False
                  ) -> torch.Tensor:
    """K8's cluster shape at these sizes doing only its per-step exchange
    of h through distributed shared memory (st.async stores onto
    mbarriers), S times: the floor a step of K8 can reach.  With
    ``backward``, K9's shape and exchange instead: a float4 (a unit's four
    gate gradients) a unit a row to every block, K9's floor.  Returns the
    ``(B, H, hd)`` values it carried, S everywhere when every store
    arrived in its step.  A measurement probe: not a K8 or K9 launch."""
    out = torch.zeros((b, heads, hd), dtype=torch.float32, device=device)
    lib = _build.library("slstm_scan")
    fn = (lib.mgg_slstm_bwd_cluster_probe if backward
          else lib.mgg_slstm_cluster_probe)
    rc = fn(out.data_ptr(), b, s, heads, hd, bt, cluster, _stream(out.device))
    _raise_on(rc, "slstm cluster probe")
    return out


def reset_launch_counts() -> None:
    slstm_scan.launches = 0
    slstm_scan_backward.launches = 0


def launch_counts() -> dict:
    return {"slstm_scan": slstm_scan.launches,
            "slstm_scan_backward": slstm_scan_backward.launches}
