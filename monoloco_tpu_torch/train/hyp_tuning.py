"""Random hyperparameter search: the port of `monoloco_tpu/train/hyp_tuning.py`.

The same search space, drawn the same way: `random.seed` and
`np.random.seed(r_seed)`, then shuffled grids of sched_gamma, sched_step,
batch size, hidden size and n_stage, and `6 * multiplier` log-uniform lrs
in [5e-4, 1e-2]. These draws are pure Python and numpy, so the trial list
equals the JAX package's. The best trial is the first with the strictly
lowest validation 'd' under 20 m; if none is under it, the last one is kept.
The result is `data/models/hyp-monoloco-<time>.pkl` (`hyp-ms-` for
MonStereo) and the log JSON `data/logs/hyp-...-<time>` with the JAX keys.

Two executors:
- serial (the default): one `Trainer` a trial (`no_save`), `train()` then
  `evaluate()`, as the JAX package's serial loop;
- stacked (`MONOLOCO_TPU_HYP_PARALLEL=1`): the trials are grouped by (bs,
  hidden, n_stage); a group of one runs the plain Trainer, a larger one
  trains its T trials as one stacked model (every weight with a leading
  trial axis, each product one `torch.baddbmm` over the trials,
  `models/loco.py`'s `loco_forward_train_stacked`; BatchNorm one
  `F.batch_norm` a trial). The trials of a group share the rows and
  keep-masks of every step, drawn once from one generator seeded with
  r_seed, as each serial trial draws them (the same bs and hidden give the
  same stream); each keeps its own lr, gamma and step, its own gradient
  clip (its own global norm) and its own best tracking. Adam is written out
  on the stacked tensors to `torch.optim.Adam`'s single-tensor formula,
  with a step size per trial. On the CPU a stacked trial equals its serial
  run bit for bit. A step of T trials issues far fewer kernels than T lone
  steps, which matters where the step is bound by its launches.
"""

import copy
import datetime
import json
import logging
import math
import os
import random
import time

import numpy as np
import torch

from ..models import loco_forward_stacked, loco_forward_train_stacked, save_checkpoint
from .losses import composite_losses, multitask_loss, weighted_total
from .trainer import ADAM_BETAS, ADAM_EPS, GRAD_CLIP, Trainer, _leaves


def _parallel_requested():
    return os.environ.get('MONOLOCO_TPU_HYP_PARALLEL', '0').strip().lower() in (
        '1', 'on', 'true', 'yes')


def _stack_tree(tree, n):
    if isinstance(tree, dict):
        return {k: _stack_tree(v, n) for k, v in tree.items()}
    return torch.stack([tree.detach()] * n).contiguous()


def _take(tree, k):
    if isinstance(tree, dict):
        return {key: _take(v, k) for key, v in tree.items()}
    return tree[k].detach().clone()


class HypTuning:

    def __init__(self, joints, epochs, monocular=False, dropout=0.2, multiplier=1, r_seed=1):
        self.joints = joints
        self.monocular = monocular
        self.dropout = dropout
        self.num_epochs = epochs
        self.r_seed = r_seed
        dir_out = os.path.join('data', 'models')
        dir_logs = os.path.join('data', 'logs')
        os.makedirs(dir_out, exist_ok=True)
        os.makedirs(dir_logs, exist_ok=True)
        name_out = 'hyp-monoloco-' if monocular else 'hyp-ms-'
        self.path_log = os.path.join(dir_logs, name_out)
        self.path_model = os.path.join(dir_out, name_out)

        logging.basicConfig(level=logging.INFO)
        self.logger = logging.getLogger(__name__)

        random.seed(r_seed)
        np.random.seed(r_seed)
        self.sched_gamma_list = [0.8, 0.9, 1, 0.8, 0.9, 1] * multiplier
        random.shuffle(self.sched_gamma_list)
        self.sched_step = [10, 20, 40, 60, 80, 100] * multiplier
        random.shuffle(self.sched_step)
        self.bs_list = [64, 128, 256, 512, 512, 1024] * multiplier
        random.shuffle(self.bs_list)
        self.hidden_list = [512, 1024, 2048, 512, 1024, 2048] * multiplier
        random.shuffle(self.hidden_list)
        self.n_stage_list = [3, 3, 3, 3, 3, 3] * multiplier
        random.shuffle(self.n_stage_list)
        aa, bb = math.log10(0.0005), math.log10(0.01)
        self.lr_list = [10 ** x for x in np.random.uniform(aa, bb, 6 * multiplier)]

    # ------------------------------------------------------------------

    def _trial_combos(self):
        return [dict(lr=lr, bs=self.bs_list[i], sched_gamma=self.sched_gamma_list[i],
                     sched_step=self.sched_step[i], hidden_size=self.hidden_list[i],
                     n_stage=self.n_stage_list[i])
                for i, lr in enumerate(self.lr_list)]

    def groups(self):
        """{(bs, hidden, n_stage): [trial indices]} in order of first
        appearance: the stacked executor's groups."""
        out = {}
        for idx, c in enumerate(self._trial_combos()):
            out.setdefault((c['bs'], c['hidden_size'], c['n_stage']), []).append(idx)
        return out

    def _trial_args(self, args, c):
        trial_args = copy.copy(args)
        trial_args.lr = c['lr']
        trial_args.bs = c['bs']
        trial_args.sched_gamma = c['sched_gamma']
        trial_args.sched_step = c['sched_step']
        trial_args.hidden_size = c['hidden_size']
        trial_args.n_stage = c['n_stage']
        trial_args.no_save = True
        return trial_args

    def _dic_best(self, c, acc_val, best_epoch):
        return {'lr': c['lr'], 'joints': self.joints, 'bs': c['bs'],
                'monocular': self.monocular, 'sched_gamma': c['sched_gamma'],
                'sched_step': c['sched_step'], 'hidden_size': c['hidden_size'],
                'n_stage': c['n_stage'], 'acc_val': float(acc_val), 'best_epoch': best_epoch,
                'random_seed': self.r_seed}

    def train(self, args):
        if _parallel_requested():
            return self._train_parallel(args)
        return self._train_serial(args)

    # ------------------------------------------------------------------
    # Serial path

    def _train_serial(self, args):
        best_acc_val = 20
        dic_best, dic_err_best, best_model = {}, {}, None
        start = time.time()
        cnt = 0
        self.trial_results = []
        for c in self._trial_combos():
            training = Trainer(self._trial_args(args, c))
            best_epoch = training.train()
            dic_err, model = training.evaluate()
            acc_val = dic_err['val']['all']['d']
            self.trial_results.append((float(acc_val), best_epoch))
            cnt += 1
            print(f"Combination number: {cnt}")
            if acc_val < best_acc_val:
                dic_best = self._dic_best(c, acc_val, best_epoch)
                dic_err_best = dic_err
                best_acc_val = acc_val
                best_model = model

        if best_model is None:
            # Every trial diverged (NaN) or validated above the threshold:
            # keep the last trial so the search still writes a model.
            self.logger.warning("No trial beat the %.1f m threshold; "
                                "saving the last trial's model", best_acc_val)
            best_model = model
            dic_best = {'joints': self.joints, 'acc_val': float(acc_val),
                        'random_seed': self.r_seed, 'note': 'no trial under threshold'}
        return self._finish(start, cnt, dic_best, dic_err_best, best_model)

    # ------------------------------------------------------------------
    # Stacked path: one stacked model per (bs, hidden, n_stage) group

    def _train_parallel(self, args):
        start = time.time()
        combos = self._trial_combos()
        results = [None] * len(combos)   # idx -> (acc_val, best_epoch, params, bn_state)
        self._group_trainers = {}
        for (bs, hidden, n_stage), idxs in self.groups().items():
            self.logger.info("Group bs=%d hidden=%d n_stage=%d: %d trials stacked",
                             bs, hidden, n_stage, len(idxs))
            group = self._run_group(args, [combos[i] for i in idxs])
            for k, idx in enumerate(idxs):
                results[idx] = group[k]
        self.trial_results = [(acc, epoch) for acc, epoch, _, _ in results]

        # The winner in the original trial order, under the serial loop's
        # strictly-less rule against the 20 m threshold.
        best_acc_val = 20
        dic_best, dic_err_best, best_model = {}, {}, None
        for idx, (c, (acc_val, best_epoch, params, bn_state)) in enumerate(zip(combos, results)):
            print(f"Combination number: {idx + 1}")
            if acc_val < best_acc_val:
                dic_best = self._dic_best(c, acc_val, best_epoch)
                best_acc_val = acc_val
                best_model = (params, bn_state)

        if best_model is not None:
            # The winner's per-cluster evaluation (the serial path prints it
            # for every trial).
            t = self._group_trainers[(dic_best['bs'], dic_best['hidden_size'],
                                      dic_best['n_stage'])]
            t.params, t.bn_state = best_model
            dic_err_best, _ = t.evaluate()
        else:
            acc_val, _, params, bn_state = results[-1]
            self.logger.warning("No trial beat the %.1f m threshold; "
                                "saving the last trial's model", best_acc_val)
            best_model = (params, bn_state)
            dic_best = {'joints': self.joints, 'acc_val': float(acc_val),
                        'random_seed': self.r_seed, 'note': 'no trial under threshold'}
        return self._finish(start, len(combos), dic_best, dic_err_best, best_model)

    def _run_group(self, args, trial_combos):
        """Train a group's trials at once; returns per trial (best val d,
        best epoch, best params, best bn_state)."""
        t = Trainer(self._trial_args(args, trial_combos[0]))
        c0 = trial_combos[0]
        self._group_trainers[(c0['bs'], c0['hidden_size'], c0['n_stage'])] = t
        if len(trial_combos) == 1:
            t.train()
            return [(float(t.best_acc), int(t.best_epoch), t.params, t.bn_state)]
        return StackedTrials(t, trial_combos).train(self.num_epochs)

    # ------------------------------------------------------------------

    def _finish(self, start, cnt, dic_best, dic_err_best, best_model):
        _ = dic_err_best
        now_time = datetime.datetime.now().strftime("%Y%m%d-%H%M")[2:]
        self.path_model = self.path_model + now_time + '.pkl'
        params, bn_state = best_model
        save_checkpoint(self.path_model, params, bn_state, meta=dic_best)
        with open(self.path_log + now_time, 'w') as f:
            json.dump(dic_best, f)
        end = time.time()
        print('\n\n\n')
        self.logger.info(" Tried %d combinations", cnt)
        self.logger.info(" Total time for hyperparameters search: %.2f minutes",
                         (end - start) / 60)
        self.logger.info(" Best hyperparameters are:")
        for key, value in dic_best.items():
            self.logger.info(" %s: %s", key, value)
        self.logger.info("Final accuracy Val: %.2f", dic_best.get('acc_val', float('nan')))
        self.logger.info("Saved the model: %s", self.path_model)
        return dic_best


class StackedTrials:
    """T trials of one (bs, hidden, n_stage) trained as one stacked model on
    the data, initial weights, generator and precision of the Trainer `t`
    (built for the first trial), each trial with its combo's lr, gamma and
    step."""

    def __init__(self, t, trial_combos):
        self.t = t
        self.n = len(trial_combos)
        self.lrs = [float(c['lr']) for c in trial_combos]
        self.gammas = [float(c['sched_gamma']) for c in trial_combos]
        self.steps = [max(int(c['sched_step']), 1) for c in trial_combos]
        self.params = _stack_tree(t.params, self.n)
        self.bn_state = _stack_tree(t.bn_state, self.n)
        self.leaves = _leaves(self.params)
        for leaf in self.leaves:
            leaf.requires_grad_(True)
        self.log_sigmas = None
        trainable = list(self.leaves)
        if t.log_sigmas is not None:
            self.log_sigmas = _stack_tree(t.log_sigmas, self.n).requires_grad_(True)
            trainable.append(self.log_sigmas)
        self.trainable = trainable
        self.exp_avg = [torch.zeros_like(p) for p in trainable]
        self.exp_avg_sq = [torch.zeros_like(p) for p in trainable]
        self.n_steps = 0

    def _per_trial(self, values):
        """A (T,) tensor viewed to broadcast over a leaf (T, ...)."""
        return lambda leaf: values.view((self.n,) + (1,) * (leaf.dim() - 1))

    def step(self, x, y, masks=None):
        """One step of every trial on the shared batch (x, y). Returns the
        trials' losses (T,) and their gradient norms before clipping (T,)."""
        t = self.t
        with t._precision():
            out, new_bn = loco_forward_train_stacked(self.params, self.bn_state, x, t.dropout,
                                                     masks=masks, generator=t.gen)
        totals = []
        for k in range(self.n):
            values = composite_losses(out[k], y, t.tasks, phase='train')
            sig = None if self.log_sigmas is None else self.log_sigmas[k]
            totals.append(weighted_total(values, t.lambdas, sig)[0])
        totals = torch.stack(totals)
        for p in self.trainable:
            p.grad = None
        with t._precision(backward=True):
            totals.sum().backward()
        grads = [p.grad for p in self.trainable]
        with torch.no_grad():
            # Each trial's global norm over its model gradients (the
            # log-sigmas are not clipped), as clip_grad_norm_: per-tensor
            # norms, then the norm of those.
            norms = torch.stack([torch.linalg.vector_norm(g.reshape(self.n, -1), dim=1)
                                 for g in grads[:len(self.leaves)]], dim=1)
            gnorm = torch.linalg.vector_norm(norms, dim=1)
            clip = torch.clamp(GRAD_CLIP / (gnorm + 1e-6), max=1.0)
            view = self._per_trial(clip)
            for g in grads[:len(self.leaves)]:
                g.mul_(view(g))
            self._adam(grads)
        self.n_steps += 1
        self.bn_state = new_bn
        return totals.detach(), gnorm

    def _adam(self, grads):
        """`torch.optim.Adam`'s update (its single-tensor formula) with each
        trial's lr at the update count before this one."""
        b1, b2 = ADAM_BETAS
        step = self.n_steps + 1
        bias1 = 1 - b1 ** step
        bias2_sqrt = (1 - b2 ** step) ** 0.5
        lrs = [lr * gamma ** math.floor(self.n_steps / ts)
               for lr, gamma, ts in zip(self.lrs, self.gammas, self.steps)]
        step_size = torch.tensor([lr / bias1 for lr in lrs], dtype=torch.float32,
                                 device=self.t.device)
        view = self._per_trial(step_size)
        for p, g, m, v in zip(self.trainable, grads, self.exp_avg, self.exp_avg_sq):
            m.lerp_(g, 1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (v.sqrt() / bias2_sqrt).add_(ADAM_EPS)
            p.sub_(view(p) * m / denom)

    def val_d(self):
        """Each trial's validation 'd' loss (T,) on the val set, eval mode."""
        t = self.t
        with torch.no_grad():
            with t._precision():
                out = loco_forward_stacked(self.params, self.bn_state, t.x_va).float()
            d_index = list(t.tasks).index(t.val_task)
            return torch.stack([multitask_loss(out[k], t.y_va, t.tasks, t.lambdas, phase='val')
                                [1][d_index] for k in range(self.n)])

    def train(self, num_epochs):
        """`num_epochs` epochs of shared batches; each trial keeps the
        weights of its epoch with the strictly lowest val 'd'. Returns per
        trial (best val d, best epoch, params, bn_state)."""
        t = self.t
        best_acc = [1e6] * self.n
        best_epoch = [0] * self.n
        best = [(_take(self.params, k), _take(self.bn_state, k)) for k in range(self.n)]
        for epoch in range(num_epochs):
            perm = t._permutation(epoch)
            for i, start in enumerate(range(0, t.n_train, t.bs)):
                idx = perm[start:start + t.bs]
                self.step(t.x_tr[idx], t.y_tr[idx], t._step_masks(epoch, i, idx.shape[0]))
            accs = self.val_d().cpu().numpy()
            for k in range(self.n):
                if accs[k] < best_acc[k]:
                    best_acc[k], best_epoch[k] = float(accs[k]), epoch
                    best[k] = (_take(self.params, k), _take(self.bn_state, k))
        return [(best_acc[k], best_epoch[k], best[k][0], best[k][1]) for k in range(self.n)]
