"""What the plain references share: TF32 rounding for the control, the
sum of gathered feature rows, cross-entropy and Adam.

Matrix products go through ``mm``: float32, or, for the control, each
operand, the backward's too, rounded to TF32 first (10 mantissa bits, to
nearest), which is what a TF32 product on the card computes; the sums of
gathered rows round those rows to TF32 for it too.
"""

from __future__ import annotations

import torch

# the precision of Adam's bias corrections: float32, as the card's
# capturable Adam computes them (on the CPU, torch's Adam takes them in
# float64: the CPU tests set this)
BIAS_CORRECTION_DTYPE = torch.float32


def tf32(a: torch.Tensor) -> torch.Tensor:
    """``a`` (float32) rounded to TF32's 10 mantissa bits, ties away from
    zero, as the card converts an operand."""
    bits = a.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


class _TF32Product(torch.autograd.Function):
    """``a @ b`` with every operand, the backward's too, in TF32."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return tf32(a) @ tf32(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = tf32(g)
        return g @ tf32(b).T, tf32(a).T @ g


def mm(a: torch.Tensor, b: torch.Tensor, low: bool) -> torch.Tensor:
    return _TF32Product.apply(a, b) if low else a @ b


def row_sum(g, ids: torch.Tensor, take: torch.Tensor, exact, low: bool,
            budget: int = 1 << 24) -> torch.Tensor:
    """[B, F] sum over each row's taken ``ids`` of their feature rows:
    exact where ``exact`` [B] (everywhere when None), else the stored
    ones; in blocks of rows of about ``budget`` gathered elements."""
    b, k = ids.shape
    f = g.features.shape[1]
    step = max(1, budget // max(k * f, 1))
    out = [g.features.new_zeros((0, f))]
    for i in range(0, b, step):
        sl = slice(i, i + step)
        rows = g.features[ids[sl]]
        if exact is not None and g.stored is not g.features:
            rows = torch.where(exact[sl, None, None], rows,
                               g.stored[ids[sl]])
        if low:
            rows = tf32(rows)
        out.append(torch.where(take[sl, :, None], rows, 0.0).sum(1))
    return torch.cat(out)


def ce(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """[B] cross-entropy of the integer labels ``y``."""
    return -torch.log_softmax(logits, dim=1).gather(1, y[:, None])[:, 0]


def adam_steps(params0: dict, batches, weights, loss_fn, *, lr: float,
               weight_decay: float) -> dict:
    """Adam steps, one a row of ``batches`` / ``weights``, from
    ``params0``, on ``loss_fn(params, nodes, weights)``; betas 0.9,
    0.999, eps 1e-8, the weight decay added to the gradient.  Returns the
    losses, the first step's gradient with the weight decay added (what
    Adam's moments take), and the parameters after the last step."""
    p = {k: v.detach().clone() for k, v in params0.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    b1, b2, eps = 0.9, 0.999, 1e-8
    # 1 - 0.999 is 1.3e-5 off in float32, which moves every update by
    # 6e-6: the bias corrections are taken as the program's Adam takes them
    f32 = lambda x: torch.tensor(x, dtype=BIAS_CORRECTION_DTYPE)
    losses, first_grad = [], None
    for t, (nodes, w) in enumerate(zip(batches, weights), start=1):
        leaves = {k: x.clone().requires_grad_(True) for k, x in p.items()}
        lv = loss_fn(leaves, nodes, w)
        grads = torch.autograd.grad(lv, list(leaves.values()))
        losses.append(float(lv.detach()))
        with torch.no_grad():
            step = {}
            for (k, x), gr in zip(p.items(), grads):
                gd = gr + weight_decay * x
                step[k] = gd
                m[k] = b1 * m[k] + (1 - b1) * gd
                v2[k] = b2 * v2[k] + (1 - b2) * gd * gd
                bc1 = float(1 - f32(b1) ** t)
                bc2 = float(1 - f32(b2) ** t)
                denom = v2[k].sqrt() / bc2 ** 0.5 + eps
                p[k] = x - (lr / bc1) * m[k] / denom
            if first_grad is None:
                first_grad = step
    return {"losses": losses, "grad": first_grad, "params": p}
