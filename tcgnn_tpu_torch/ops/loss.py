"""The port's NLL loss: the mean negative log-likelihood over all nodes.

    loss = -(1 / |K|) * sum_{i in K} logp[i, y[i]],   K = {i : y[i] != -100}

as ``torch.nn.functional.nll_loss(logp, y)`` computes it (mean reduction,
``ignore_index`` -100, no class weights).  The training step takes its loss
through this module (``train.F``).  No caller feeds a -100 label (every step
trains over all N labelled nodes); the ignored rows are kept so that this
module computes what ``F.nll_loss`` does, the function ``train.F.nll_loss``
stands for wherever a caller swaps ``train.F``.

Replaces no TPU kernel: the JAX package takes a one-hot NLL that XLA fuses
into the log-softmax (``tcgnn_tpu/train.py:180``).  Added because PyTorch's
``F.nll_loss`` reduces all N rows in one thread block, forward and backward,
so its time grows with the rows (about 1.7 ms of Yeast's 5.7 ms epoch on an
H100).  The loss is bound by bytes: the labels (8N), one f32 of ``logp`` a
row (4N) and the N x C gradient (4NC), each moved once: 34 MB on Yeast, 41
MB on amazon0505, 0.010-0.012 ms at 3.35 TB/s.

``nll_loss`` runs, for CUDA tensors, the hand-written kernel pair of
``csrc/nll.cu`` (``_NLLLoss``): the forward over a grid of up to
``FORWARD_BLOCKS`` blocks, one thread a row, whose block partials (double)
the last block sums in a fixed order, so a replay gives the same bits
without float atomics; the backward one flat pass writing the whole
gradient.  For CPU tensors it runs the plain PyTorch version
``nll_loss_torch`` (a gather, a masked sum and a count), under autograd.
Counters: ``nll_loss.launches`` (kernel launches, the backward's included)
and ``.plain_calls``.
"""

from __future__ import annotations

import torch

from tcgnn_tpu_torch.ops import _kernels

IGNORE_INDEX = -100
# The forward's grid: at most 1,024 blocks of 256 threads, which fill an
# H100's 132 SMs, each with its partial sum and count in the scratch.
FORWARD_BLOCKS = 1024


def nll_loss_torch(logp: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``-logp[i, y[i]]`` summed over the rows whose
    label is not ``IGNORE_INDEX``, over their count."""
    keep = y != IGNORE_INDEX
    picked = logp.gather(1, torch.where(keep, y, 0)[:, None])[:, 0]
    return -torch.where(keep, picked, 0.0).sum() / keep.sum()


class _NLLLoss(torch.autograd.Function):
    """The kernel pair: the forward saves the labels and the count of rows
    kept, which the backward reads on the device with the loss's gradient."""

    @staticmethod
    def forward(ctx, logp, y):
        n, c = logp.shape
        loss = torch.empty((), dtype=torch.float32, device=logp.device)
        count = torch.empty((), dtype=torch.float32, device=logp.device)
        scratch = torch.empty(2 * FORWARD_BLOCKS + 1, dtype=torch.float64, device=logp.device)
        _kernels.call("nll", "tcgnn_nll_forward", logp.device, logp.data_ptr(), y.data_ptr(),
                      scratch.data_ptr(), loss.data_ptr(), count.data_ptr(), n, c,
                      FORWARD_BLOCKS, _kernels.stream_of(logp))
        nll_loss.launches += 1
        ctx.save_for_backward(y, count)
        ctx.num_classes = c
        return loss

    @staticmethod
    def backward(ctx, g):
        y, count = ctx.saved_tensors
        n, c = y.shape[0], ctx.num_classes
        grad = torch.empty((n, c), dtype=torch.float32, device=y.device)
        _kernels.call("nll", "tcgnn_nll_backward", y.device, g.data_ptr(), count.data_ptr(),
                      y.data_ptr(), grad.data_ptr(), n, c, _kernels.stream_of(grad))
        nll_loss.launches += 1
        return grad, None


@_kernels.counted
def nll_loss(logp: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The mean NLL of ``logp`` ``[N, C]`` f32 at labels ``y`` ``[N]`` int64,
    a 0-d f32 tensor.  A CUDA tensor runs the kernels (or raises); a CPU
    tensor runs the plain version.  A label outside ``[0, C)`` that is not
    ``IGNORE_INDEX`` fails a device assertion on the card, an index error
    on the CPU."""
    if logp.dim() != 2 or y.dim() != 1 or y.shape[0] != logp.shape[0]:
        raise ValueError(f"nll_loss: logp of shape {tuple(logp.shape)} and labels of shape "
                         f"{tuple(y.shape)}, expected [N, C] and [N]")
    if logp.dtype != torch.float32 or y.dtype != torch.int64:
        raise TypeError(f"nll_loss: logp must be float32 and labels int64, got {logp.dtype} "
                        f"and {y.dtype}")
    if y.device != logp.device:
        raise ValueError(f"nll_loss: labels on {y.device}, logp on {logp.device}")
    if logp.device.type == "cpu":
        nll_loss.plain_calls += 1
        return nll_loss_torch(logp, y)
    if logp.device.type != "cuda":
        raise ValueError(f"nll_loss: no kernel for device {logp.device}")
    if not (logp.is_contiguous() and y.is_contiguous()):
        raise ValueError("nll_loss: logp and labels must be contiguous")
    return _NLLLoss.apply(logp, y)
