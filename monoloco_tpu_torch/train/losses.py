"""Multi-task losses as masked reductions over torch tensors: a copy of
`monoloco_tpu/train/losses.py`.

- Laplace NLL on the relative distance error:
  |1 - mu/x| * exp(-s) + 0.01 + s + 2;
- L1 for x/y/h/w/l/ori, BCE-with-logits for the stereo aux flag;
- validation-only variants: plain |mu - x| for 'd', the angle error in
  degrees for 'ori';
- the multi-task total: sum of lambda-weighted task losses, or with learned
  log-sigmas (auto-tune) sum lam*l/(2 sigma^2) + sum log sigma.

Every reduction takes an optional row mask, so a padded batch gives the
values of the ragged one.
"""

import math

import torch

from ..network.decode import extract_labels, extract_labels_aux, extract_outputs

LOSS_TASKS_STEREO = ('d', 'x', 'y', 'h', 'w', 'l', 'ori', 'aux')
LOSS_TASKS_MONO = ('d', 'x', 'y', 'h', 'w', 'l', 'ori')

_EPS = 0.01
_CONST = 2.0


def _masked_mean(values, mask):
    """Mean over rows; `values` (m, k) is first meaned over k, then masked
    over rows."""
    row_vals = values.mean(dim=-1)
    if mask is None:
        return row_vals.mean()
    return (row_vals * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def laplace_loss_terms(mu_si, x, mask=None):
    """Relative Laplace NLL."""
    mu, si = mu_si[:, 0:1], mu_si[:, 1:2]
    norm = 1.0 - mu / x
    values = torch.abs(norm) * torch.exp(-si) + _EPS + si + _CONST
    return _masked_mean(values, mask)


def _l1(out, gt, mask=None):
    return _masked_mean(torch.abs(out - gt), mask)


def _bce_logits(out, gt, mask=None):
    values = torch.clamp(out, min=0) - out * gt + torch.log1p(torch.exp(-torch.abs(out)))
    return _masked_mean(values, mask)


def _l1_from_laplace(out, gt, mask=None):
    return _masked_mean(torch.abs(out[:, 0:1] - gt), mask)


def _angle_loss(orient, gt_orient, mask=None):
    angles = torch.atan2(orient[:, 0], orient[:, 1])
    gt_angles = torch.atan2(gt_orient[:, 0], gt_orient[:, 1])
    vals = torch.abs(angles - gt_angles)[:, None]
    # 180 / 3.14, not 180 / pi, as the JAX package (and the paper's code).
    return _masked_mean(vals, mask) * 180.0 / 3.14


def gaussian_loss_terms(mu_si, x, mask=None):
    """Gaussian NLL alternate (unused by default): ((x - mu)/si)^2/2 +
    log(si*sqrt(2*pi)), si floored at 0.1."""
    mu, si = mu_si[:, 0:1], mu_si[:, 1:2]
    si = torch.clamp(si, min=0.1)
    norm = x - mu
    values = (norm / si) ** 2 / 2 + torch.log(si * math.sqrt(2 * math.pi))
    return _masked_mean(values, mask)


def custom_l1_loss(out, gt, mask=None, beta=1):
    """Distance-weighted L1 alternate: weight max(0.1, 1 - d/78)^beta, from
    the detached output, emphasizes near-range errors."""
    ww = torch.clamp(1.0 - out.detach() / 78.0, min=0.1) ** beta
    return _masked_mean(torch.abs(out - gt) * ww, mask)


def _task_loss(task, phase):
    if task == 'd':
        return laplace_loss_terms if phase == 'train' else _l1_from_laplace
    if task == 'aux':
        return _bce_logits
    if task == 'ori' and phase == 'val':
        return _angle_loss
    return _l1


def composite_losses(outputs, labels, tasks, phase, mask=None):
    """Per-task losses in task order; `phase` picks the train or the
    validation flavours."""
    outs = extract_outputs(outputs, tasks=tasks)
    if len(tasks) == 1 and tasks[0] == 'aux':
        gts = extract_labels_aux(labels, tasks=tasks)
    else:
        gts = extract_labels(labels, tasks=tasks)
    return [_task_loss(t, phase)(o, g, mask) for t, o, g in zip(tasks, outs, gts)]


def multitask_loss(outputs, labels, tasks, lambdas, phase='train', mask=None,
                   log_sigmas=None):
    """Total multi-task loss.

    Without log_sigmas: sum(lam_i * l_i). With log_sigmas (auto-tune):
    sum(lam_i * l_i / (2 exp(log_sigma_i)^2)) + sum(log_sigma_i). The values
    returned beside the total are the weighted train terms (phase 'train')
    or the raw validation losses, with exp(log_sigma_i) appended under
    auto-tune (phase 'val'). Returns (total, task_values_list).
    """
    values = composite_losses(outputs, labels, tasks, phase='train', mask=mask)
    total, weighted = weighted_total(values, lambdas, log_sigmas)
    if phase == 'val':
        val_values = composite_losses(outputs, labels, tasks, phase='val', mask=mask)
        if log_sigmas is not None:
            val_values = val_values + [torch.exp(s) for s in log_sigmas]
        return total, val_values
    return total, weighted


def weighted_total(values, lambdas, log_sigmas=None):
    """(total, weighted terms) of `multitask_loss` from the train-flavour task
    losses `values`."""
    if log_sigmas is None:
        weighted = [lam * v for lam, v in zip(lambdas, values)]
        return sum(weighted), weighted
    sig2 = 2.0 * torch.exp(log_sigmas) ** 2
    weighted = [lam * v / sig2[i] for i, (lam, v) in enumerate(zip(lambdas, values))]
    return sum(weighted) + log_sigmas.sum(), weighted
