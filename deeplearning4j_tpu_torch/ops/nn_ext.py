"""The peephole LSTM and the YOLOv2 training loss (counterpart of
``deeplearning4j_tpu/ops/nn_ext.py`` ``graves_lstm_cell`` /
``graves_lstm_layer`` :29-64, whose recurrence runs in the kernels of
``kernels/recurrence.py``, and ``yolo2_loss`` :103-160).

The peephole (Graves) LSTM's gate order is ``[i, f, g, o]``; ``w_peep``
is (3, U): i and f see ``c_{t-1}``, o sees ``c_t``.

Both inputs are channels-last: ``pred`` (B, H, W, A*(5+C)), the raw
network output, and ``labels`` (B, H, W, 4+C), each cell's box corners
(x1, y1, x2, y2) in grid units and its class one-hot (a cell whose class
vector is all zero holds no object). The responsible anchor of a cell is
the one whose shape has the best IoU with the cell's box, the first of
equals (``argmax``, as ``jnp.argmax``)."""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.kernels import recurrence
from deeplearning4j_tpu_torch.ops.dtypes import promote
from deeplearning4j_tpu_torch.ops.registry import op


@op("graves_lstm_layer", "nn")
def graves_lstm_layer(x, h0, c0, w_ih, w_hh, w_peep, b,
                      time_major: bool = False,
                      return_sequences: bool = True):
    """A peephole LSTM over a sequence: ``(out, hT, cT)``, ``out`` every
    timestep's hidden state or, without ``return_sequences``, ``hT``. x:
    (B, T, in), h0/c0: (B, U), w_ih: (in, 4U), w_hh: (U, 4U), w_peep: (3,
    U), b: (4U,). The recurrence is ``kernels/recurrence.py``'s
    ``recurrence_sequence``."""
    x, h0, c0, w_ih, w_hh, w_peep, b = promote(x, h0, c0, w_ih, w_hh, w_peep,
                                               b)
    hs, h_t, c_t = recurrence.recurrence_sequence(
        "graves", x.transpose(0, 1) if time_major else x, h0, w_ih, w_hh, b,
        c0=c0, w_peep=w_peep)
    if not return_sequences:
        return h_t, h_t, c_t
    return (hs.transpose(0, 1) if time_major else hs), h_t, c_t


@op("graves_lstm_cell", "nn")
def graves_lstm_cell(x, h_prev, c_prev, w_ih, w_hh, w_peep, b):
    """One peephole LSTM step ``(h, c)``: the sequence op over one
    timestep."""
    _, h, c = graves_lstm_layer(x.unsqueeze(1), h_prev, c_prev, w_ih, w_hh,
                                w_peep, b)
    return h, c


_ANCHORS: Dict[Tuple, torch.Tensor] = {}


def _anchor_tensor(anchors, dtype, device) -> torch.Tensor:
    """The anchors as an (A, 2) tensor on ``device``, made by fills (a
    copy from the host is not allowed while a CUDA graph is captured) and
    kept for later calls (the warm-up steps before a capture make it)."""
    key = (tuple(float(a) for a in anchors), dtype, device)
    t = _ANCHORS.get(key)
    if t is None:
        t = torch.empty(len(key[0]), dtype=dtype, device=device)
        for i, a in enumerate(key[0]):
            t[i] = a
        t = t.reshape(-1, 2)
        if not (device.type == "cuda"
                and torch.cuda.is_current_stream_capturing()):
            _ANCHORS[key] = t
    return t


@op("yolo2_loss", "nn", n_inputs=2)
def yolo2_loss(pred, labels, anchors=(), lambda_coord: float = 5.0,
               lambda_noobj: float = 0.5):
    anchors = _anchor_tensor(anchors, pred.dtype, pred.device)
    n_a = anchors.shape[0]
    b, h, w, _ = pred.shape
    n_c = labels.shape[-1] - 4
    p = pred.reshape(b, h, w, n_a, 5 + n_c)
    txy, twh, tconf, tcls = p[..., 0:2], p[..., 2:4], p[..., 4], p[..., 5:]
    pxy = torch.sigmoid(txy)
    pwh = anchors * torch.exp(torch.clamp(twh, -8.0, 8.0))
    pconf = torch.sigmoid(tconf)

    cls = labels[..., 4:]
    obj = (cls.sum(dim=-1) > 0).to(pred.dtype)                 # (B, H, W)
    x1, y1, x2, y2 = (labels[..., i] for i in range(4))
    gwh = torch.stack([x2 - x1, y2 - y1], -1)
    cx = torch.arange(w, dtype=pred.dtype, device=pred.device)[None, None, :]
    cy = torch.arange(h, dtype=pred.dtype, device=pred.device)[None, :, None]
    gxy = torch.stack([(x1 + x2) / 2 - cx, (y1 + y2) / 2 - cy], -1)

    inter = torch.minimum(gwh[..., None, 0], anchors[:, 0]) * \
        torch.minimum(gwh[..., None, 1], anchors[:, 1])
    union = gwh[..., 0:1] * gwh[..., 1:2] + anchors[:, 0] * anchors[:, 1] \
        - inter
    iou_a = inter / torch.clamp_min(union, 1e-8)               # (B,H,W,A)
    resp = F.one_hot(torch.argmax(iou_a, -1), n_a).to(pred.dtype)
    resp = resp * obj[..., None]

    exy = torch.square(pxy - gxy[..., None, :]).sum(-1)
    ewh = torch.square(torch.sqrt(torch.clamp_min(pwh, 1e-8))
                       - torch.sqrt(torch.clamp_min(gwh[..., None, :], 1e-8))
                       ).sum(-1)
    loss_coord = (resp * (exy + ewh)).sum()
    conf_target = resp * iou_a
    loss_obj = (resp * torch.square(pconf - conf_target)).sum()
    loss_noobj = ((1.0 - resp) * torch.square(pconf)).sum()
    pc = torch.softmax(tcls, dim=-1)
    loss_cls = (resp[..., None] * torch.square(pc - cls[..., None, :])).sum()
    n = torch.clamp_min(obj.sum(), 1.0)
    return (lambda_coord * loss_coord + loss_obj
            + lambda_noobj * loss_noobj + loss_cls) / n
