"""Training loop of the Loco model in torch: the port of
`monoloco_tpu/train/trainer.py`'s `Trainer`.

- Tasks ('d', 'x', 'y', 'h', 'w', 'l', 'ori', 'aux'), aux dropped for mono.
- Adam (betas 0.9/0.999, eps 1e-8) over the model and, with
  `--auto_tune_mtl`, the loss's log-sigmas; the learning rate is
  `lr * gamma ** floor(step / sched_step)`, taken at the count of updates
  before each one and stepped every *batch*, as `optax.scale_by_adam` with
  the JAX package's staircase.
- The global norm of the model's gradients is clipped to 3 (the
  log-sigmas are not clipped).
- The partial last batch is a batch of its real rows only, so its BN
  statistics and loss means cover them alone (the JAX package pads it and
  masks the padding out, which computes the same).
- The train logs of an epoch are the validation-flavour losses of each
  step's outputs, weighted by the rows of the batch; the weights kept are
  those of the epoch with the strictly lowest validation 'd' loss.
- `evaluate()`: the whole validation set's and each distance cluster's
  statistics, and the `monoloco_tpu-v1` pickle: the best weights, which
  serve, and the JAX keys of the resume state ('final_params',
  'final_bn_state', 'log_sigmas', 'meta' with the epoch and the best
  tracking), and under 'torch_train_state' the port's own: Adam's step and
  moments (numpy, in the order of the trainable tree: the model's leaves,
  then the log-sigmas), the update count and the generator's state. No
  'opt_state': the JAX package would take it for optax's.
- `--resume CKPT` continues from the final weights of CKPT, with the
  port's Adam state, update count and generator (a resumed run equals a
  straight one), or from a JAX-written blob's `opt_state` (optax's
  `scale_by_adam` count, mu and nu are torch Adam's step, exp_avg and
  exp_avg_sq), or, with neither, with fresh moments and a warning, as the
  JAX package resumes a blob without `opt_state`. The epochs run from the
  meta's `epoch` to `--epochs`; the best tracking starts from the
  checkpoint's best weights and `best_val_acc`.

One loop, epoch by epoch. The dataset, the shuffled order (`torch.randperm`
on a generator on the device, seeded from `r_seed`; dropout's keep-masks
come from the same generator), the per-epoch sums of the logs and the copy
of the best weights stay on the device; the logs come to the host once an
epoch, with the validation losses, in one copy.

Precision follows MONOLOCO_TPU_PRECISION (`utils/precision.py`): default,
float32 and int8 train in f32 with TF32 off (int8 names a serving kernel
only), tensorfloat32 turns TF32 on, bf16 runs the linear layers under
`torch.autocast(dtype=torch.bfloat16)`.
"""

import contextlib
import datetime
import logging
import math
import os
import time
from collections import defaultdict

import numpy as np
import torch

from .. import __version__
from ..models import (init_loco_params, load_checkpoint, load_train_state, loco_forward,
                      loco_forward_train, params_from_numpy, save_train_state)
from ..models.checkpoint import ORBAX_REFUSAL
from ..models.loco import _tree_clone as _clone
from ..network.decode import extract_labels, extract_outputs
from ..utils import set_logger
from ..utils.precision import serving_precision, tf32_matmuls
from .datasets import KeypointsDataset
from .losses import (LOSS_TASKS_MONO, LOSS_TASKS_STEREO, composite_losses, multitask_loss,
                     weighted_total)

GRAD_CLIP = 3.0
ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


def refusal(args):
    """The message for a training option the port does not take, or None."""
    if any(str(getattr(args, key, None) or '').endswith('.orbax') for key in ('out', 'resume')):
        return ORBAX_REFUSAL
    if getattr(args, 'dp_devices', 1) > 1 or getattr(args, 'tp_devices', 1) > 1:
        return "train --dp_devices/--tp_devices > 1 need device meshes: ROADMAP Queue 1 item 9"
    return None


def _leaves(tree):
    """The tensors of a nested dict, in key order."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        out.extend(_leaves(v) if isinstance(v, dict) else [v])
    return out


def _jax_adam_state(opt_state):
    """(count, mu leaves, nu leaves) of a JAX trainer's `opt_state`, the
    one-element chain `(ScaleByAdamState(count, mu, nu),)` over
    {'model': params, 'log_sigmas': ...}, unpickled into placeholders that
    keep their arguments (`models/checkpoint.py`). The leaves follow the
    port's trainable order: the model's in key order, then the log-sigmas."""
    state = opt_state[0] if isinstance(opt_state, (tuple, list)) else opt_state
    fields = getattr(state, 'args', None) or tuple(state)
    count, mu, nu = fields[:3]

    def ordered(tree):
        out = _leaves(tree['model'])
        if tree.get('log_sigmas') is not None:
            out.append(tree['log_sigmas'])
        return [np.asarray(a, np.float32) for a in out]

    return int(np.asarray(count)), ordered(mu), ordered(nu)


def count_params(params):
    return sum(t.numel() for t in _leaves(params))


class Trainer:
    val_task = 'd'
    clusters = ['10', '20', '30', '40']
    input_size = dict(mono=34, stereo=68)
    output_size = dict(mono=9, stereo=10)
    dir_figures = os.path.join('figures', 'losses')

    def __init__(self, args, device=None):
        """`args` carries the JAX CLI's train flags. The device is `device`
        when given, else the CPU under `args.disable_cuda`, else the card
        (`default_device()` raises without one)."""
        message = refusal(args)
        if message:
            raise SystemExit(message)
        assert os.path.exists(args.joints), "Input file not found"
        self.mode = args.mode
        self.joints = args.joints
        self.num_epochs = args.epochs
        self.no_save = args.no_save
        self.print_loss = getattr(args, 'print_loss', False)
        self.lr = args.lr
        self.bs = args.bs
        self.sched_step = args.sched_step
        self.sched_gamma = args.sched_gamma
        self.hidden_size = args.hidden_size
        self.n_stage = args.n_stage
        self.dropout = args.dropout
        self.r_seed = args.r_seed
        self.auto_tune_mtl = getattr(args, 'auto_tune_mtl', False)
        self.profile = getattr(args, 'profile', None)
        self.resume = getattr(args, 'resume', None)
        if device is None:
            if getattr(args, 'disable_cuda', False):
                device = 'cpu'
            else:
                from ..network.engine import default_device
                device = default_device()
        self.device = torch.device(device)
        self.precision = serving_precision()

        if args.out:
            self.path_out = args.out
            dir_out, _ = os.path.split(self.path_out)
        else:
            dir_out = os.path.join('data', 'outputs')
            name = 'monoloco_pp' if self.mode == 'mono' else 'monstereo'
            now_time = datetime.datetime.now().strftime("%Y%m%d-%H%M")[2:]
            self.path_out = os.path.join(dir_out, name + '-' + now_time + '.pkl')
        # Nothing is written under --no_save, so a missing output directory
        # does not stop the run then.
        assert self.no_save or os.path.exists(dir_out) or not dir_out, \
            "Directory to save the model not found"
        print(self.path_out)

        self.tasks = LOSS_TASKS_MONO if self.mode == 'mono' else LOSS_TASKS_STEREO
        self.lambdas = tuple(1.0 for _ in self.tasks)

        self.datasets = {ph: KeypointsDataset(self.joints, phase=ph) for ph in ('train', 'val')}
        self.dataset_sizes = {ph: len(ds) for ph, ds in self.datasets.items()}
        self.dataset_version = self.datasets['train'].get_version()
        x_tr, y_tr = self.datasets['train'].arrays()
        x_va, y_va = self.datasets['val'].arrays()
        self.x_tr, self.y_tr = (torch.from_numpy(a).to(self.device) for a in (x_tr, y_tr))
        self.x_va, self.y_va = (torch.from_numpy(a).to(self.device) for a in (x_va, y_va))
        self.n_train = self.x_tr.shape[0]

        self._set_logger(args)
        self.logger.info('Sizes of the dataset: {}'.format(self.dataset_sizes))
        print(">>> creating model")
        self.gen = torch.Generator(device=self.device).manual_seed(self.r_seed)
        params, bn_state = init_loco_params(self.r_seed, self.input_size[self.mode],
                                            self.output_size[self.mode], self.hidden_size,
                                            self.n_stage)
        self.set_weights(params, bn_state)
        print(">>> model params: {:.3f}M".format(count_params(self.params) / 1e6))
        self.start_epoch = 0
        self._resume_best = None
        if self.resume:
            self._resume_from(self.resume)

    # ------------------------------------------------------------------

    def set_weights(self, params, bn_state, log_sigmas=None):
        """Start from (params, bn_state) — the port's or the JAX package's
        trees, of tensors or arrays — and, under auto-tune, `log_sigmas`
        (zeros when None), with a fresh optimizer and step count."""
        params, bn_state = params_from_numpy(params, bn_state, self.device)
        self.params, self.bn_state = _clone(params), _clone(bn_state)
        self._model_leaves = _leaves(self.params)
        for t in self._model_leaves:
            t.requires_grad_(True)
        self.log_sigmas = None
        if self.auto_tune_mtl:
            self.log_sigmas = (torch.zeros(len(self.tasks), device=self.device)
                               if log_sigmas is None else
                               torch.as_tensor(np.asarray(log_sigmas, np.float32),
                                               device=self.device).clone())
            self.log_sigmas.requires_grad_(True)
        self.optimizer = torch.optim.Adam(self._trainable(), lr=self.lr, betas=ADAM_BETAS,
                                          eps=ADAM_EPS)
        self.n_steps = 0

    def _trainable(self):
        """What Adam updates: the model's leaves, then the log-sigmas."""
        return self._model_leaves + ([self.log_sigmas] if self.log_sigmas is not None else [])

    def _resume_from(self, path):
        """Continue from the final state of the checkpoint `path` (module
        docstring: the port's resume state, a JAX blob's `opt_state`, or
        fresh moments)."""
        blob = load_train_state(path)
        meta = blob.get('meta', {})
        ckpt_auto = blob.get('log_sigmas') is not None
        if ckpt_auto != self.auto_tune_mtl:
            raise ValueError(
                "--resume checkpoint was trained with auto_tune_mtl="
                f"{ckpt_auto}; pass the matching --auto_tune_mtl setting")
        self.set_weights(blob.get('final_params', blob['params']),
                         blob.get('final_bn_state', blob['bn_state']), blob.get('log_sigmas'))
        state = blob.get('torch_train_state')
        if state is not None:
            adam = state['adam']
            self._load_adam(adam['step'], adam['exp_avg'], adam['exp_avg_sq'])
            self.n_steps = int(state['n_steps'])
            if state.get('generator_device') == self.device.type:
                self.gen.set_state(torch.from_numpy(np.asarray(state['generator'], np.uint8)))
            else:
                self.logger.warning(
                    "--resume: the generator's state was saved on %s and this run is on %s; "
                    "the epoch order and keep-masks restart from r_seed",
                    state.get('generator_device'), self.device.type)
        elif 'opt_state' in blob:
            adam = _jax_adam_state(blob['opt_state'])
            self._load_adam(*adam)
            self.n_steps = int(adam[0])
        else:
            self.logger.warning("--resume: %s holds no optimizer state; Adam starts with fresh "
                                "moments", path)
        self.start_epoch = int(meta.get('epoch', 0))
        # The checkpoint's best-validation weights seed the best tracking, so
        # a resumed segment that never beats them keeps them.
        if meta.get('best_val_acc') is not None:
            params, bn_state = params_from_numpy(blob['params'], blob['bn_state'], self.device)
            self._resume_best = (float(meta['best_val_acc']),
                                 float(meta.get('best_train_acc', 1e6)),
                                 int(meta.get('best_epoch', self.start_epoch)), params, bn_state)
        self.logger.info('Resumed from %s at epoch %d', path, self.start_epoch)

    def _load_adam(self, step, exp_avg, exp_avg_sq):
        """Set Adam's state of every trainable tensor: `step` a number, the
        moments numpy arrays in `_trainable()` order."""
        trainable = self._trainable()
        if len(exp_avg) != len(trainable) or len(exp_avg_sq) != len(trainable):
            raise ValueError(f"--resume: the checkpoint's Adam state has {len(exp_avg)} "
                             f"tensors, this model {len(trainable)}")
        for t, m, v in zip(trainable, exp_avg, exp_avg_sq):
            m, v = np.asarray(m, np.float32), np.asarray(v, np.float32)
            if m.shape != tuple(t.shape) or v.shape != tuple(t.shape):
                raise ValueError(f"--resume: Adam moment of shape {m.shape} for a tensor of "
                                 f"shape {tuple(t.shape)}")
            self.optimizer.state[t] = {
                'step': torch.tensor(float(step), dtype=torch.float32),
                'exp_avg': torch.from_numpy(m.copy()).to(self.device),
                'exp_avg_sq': torch.from_numpy(v.copy()).to(self.device)}

    def train_state(self):
        """The port's resume state (numpy): Adam's step and moments in
        `_trainable()` order, the update count, the generator's state."""
        exp_avg, exp_avg_sq, step = [], [], 0.0
        for t in self._trainable():
            st = self.optimizer.state.get(t, {})
            if st:
                step = float(st['step'])
                exp_avg.append(st['exp_avg'].detach().cpu().numpy())
                exp_avg_sq.append(st['exp_avg_sq'].detach().cpu().numpy())
            else:
                exp_avg.append(np.zeros(tuple(t.shape), np.float32))
                exp_avg_sq.append(np.zeros(tuple(t.shape), np.float32))
        return {'adam': {'step': step, 'exp_avg': exp_avg, 'exp_avg_sq': exp_avg_sq},
                'n_steps': self.n_steps,
                'generator': self.gen.get_state().cpu().numpy(),
                'generator_device': self.device.type}

    def _precision(self, backward=False):
        """The arithmetic of a forward (or, with `backward`, of its backward
        pass): bf16 autocast around the forward only (autograd runs each
        backward op in its forward op's type), TF32 around both."""
        if self.precision == 'bfloat16' and not backward:
            return torch.autocast(device_type=self.device.type, dtype=torch.bfloat16)
        if self.precision == 'tensorfloat32':
            return tf32_matmuls()
        return contextlib.nullcontext()

    def _permutation(self, epoch):
        """The epoch's order of the training rows, on the device."""
        return torch.randperm(self.n_train, generator=self.gen, device=self.device)

    def _step_masks(self, epoch, step, rows):
        """The keep-masks of a step of `run_epoch`: None, so that the
        training forward draws them from the trainer's generator (tests put
        in the JAX package's)."""
        return None

    def lr_at(self, step):
        """The staircase learning rate of update `step` (0-based)."""
        return self.lr * self.sched_gamma ** math.floor(step / max(int(self.sched_step), 1))

    def step(self, x, y, masks=None):
        """One optimizer step on the batch (x, y), with the keep-masks
        `masks` (drawn from the trainer's generator when None and dropout is
        on). Returns device tensors (the train loss, the model gradients'
        global norm before clipping, the logs [total, one per task] of the
        validation-flavour losses times the batch's rows)."""
        with self._precision():
            out, new_bn = loco_forward_train(self.params, self.bn_state, x, self.dropout,
                                             masks=masks, generator=self.gen)
        values = composite_losses(out, y, self.tasks, phase='train')
        total, _ = weighted_total(values, self.lambdas, self.log_sigmas)
        self.optimizer.zero_grad(set_to_none=True)
        with self._precision(backward=True):
            total.backward()
        gnorm = torch.nn.utils.clip_grad_norm_(self._model_leaves, GRAD_CLIP)
        for group in self.optimizer.param_groups:
            group['lr'] = self.lr_at(self.n_steps)
        self.optimizer.step()
        self.n_steps += 1
        self.bn_state = new_bn
        with torch.no_grad():
            # The log's total takes the log-sigmas after the update, as the
            # JAX package's step does.
            log_total, _ = weighted_total([v.detach() for v in values], self.lambdas,
                                          self.log_sigmas)
            val_values = composite_losses(out.detach(), y, self.tasks, phase='val')
            logs = torch.stack([log_total] + val_values) * x.shape[0]
        return total.detach(), gnorm, logs

    def val_metrics(self, params=None, bn_state=None):
        """[total, one per task] of the validation losses on the val set,
        eval-mode forward, on the device."""
        params = self.params if params is None else params
        bn_state = self.bn_state if bn_state is None else bn_state
        with torch.no_grad(), self._precision():
            out = loco_forward(params, bn_state, self.x_va)
        with torch.no_grad():
            total, vals = multitask_loss(out.float(), self.y_va, self.tasks, self.lambdas,
                                         phase='val', log_sigmas=self.log_sigmas)
            return torch.stack([total] + list(vals[:len(self.tasks)]))

    # ------------------------------------------------------------------

    def train(self):
        """Train for the configured epochs; returns the best epoch and leaves
        the best weights in `params`/`bn_state` (the last in
        `final_params`/`final_bn_state`), the per-epoch logs in
        `epoch_losses` and each epoch's wall (logs fetched) in
        `epoch_walls`."""
        if not self.profile:
            return self._train()
        from torch.profiler import ProfilerActivity, profile
        on_card = self.device.type == 'cuda'
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
        os.makedirs(self.profile, exist_ok=True)
        self.logger.info('Profiling to %s', self.profile)
        with profile(activities=activities) as prof:
            best_epoch = self._train()
            if on_card:
                torch.cuda.synchronize()
        prof.export_chrome_trace(os.path.join(self.profile, 'train_trace.json'))
        return best_epoch

    def _train(self):
        since = time.time()
        if self._resume_best is not None:
            best_acc, best_training_acc, best_epoch, best_params, best_bn = self._resume_best
            best_params, best_bn = _clone(best_params), _clone(best_bn)
        else:
            best_acc = 1e6
            best_training_acc = 1e6
            best_epoch = self.start_epoch
            best_params, best_bn = _clone(self.params), _clone(self.bn_state)
        epoch_losses = defaultdict(lambda: defaultdict(list))
        names = ['all'] + list(self.tasks)
        self.epoch_walls = []

        for epoch in range(self.start_epoch, self.num_epochs):
            t0 = time.perf_counter()
            both = self.run_epoch(epoch)
            self.epoch_walls.append(time.perf_counter() - t0)
            for i, name in enumerate(names):
                epoch_losses['train'][name].append(float(both[0, i]))
                epoch_losses['val'][name].append(float(both[1, i]))
            if epoch % 10 == 0:
                self._cout_epoch(epoch, epoch_losses)
            if epoch_losses['val'][self.val_task][-1] < best_acc:
                best_acc = epoch_losses['val'][self.val_task][-1]
                best_training_acc = epoch_losses['train']['all'][-1]
                best_epoch = epoch
                best_params, best_bn = _clone(self.params), _clone(self.bn_state)

        self.epoch_losses = epoch_losses
        self.last_epoch = max(self.num_epochs, self.start_epoch) - 1
        time_elapsed = time.time() - since
        print('\n\n' + '-' * 120)
        self.logger.info('Training:\nTraining complete in {:.0f}m {:.0f}s'
                         .format(time_elapsed // 60, time_elapsed % 60))
        self.logger.info('Best training Accuracy: {:.3f}'.format(best_training_acc))
        self.logger.info('Best validation Accuracy for {}: {:.3f}'.format(self.val_task, best_acc))
        self.logger.info('Saved weights of the model at epoch: {}'.format(best_epoch))

        if self.print_loss:
            self._print_losses(epoch_losses)

        self.final_params = _clone(self.params)
        self.final_bn_state = self.bn_state
        self.params, self.bn_state = best_params, best_bn
        self.best_acc = best_acc
        self.best_training_acc = best_training_acc
        self.best_epoch = best_epoch
        return best_epoch

    def run_epoch(self, epoch):
        """One epoch of steps over the shuffled training rows, then the val
        losses; returns numpy (2, 1 + n_tasks): the train logs over the
        rows, and the val losses, fetched in one copy."""
        perm = self._permutation(epoch)
        sums = torch.zeros(1 + len(self.tasks), device=self.device)
        for i, start in enumerate(range(0, self.n_train, self.bs)):
            idx = perm[start:start + self.bs]
            _, _, logs = self.step(self.x_tr[idx], self.y_tr[idx],
                                   self._step_masks(epoch, i, idx.shape[0]))
            sums += logs
        return torch.stack([sums / self.n_train, self.val_metrics()]).cpu().numpy()

    def _cout_epoch(self, epoch, epoch_losses):
        parts = [f'{epoch:.0f} ']
        for phase in ('train', 'val'):
            parts.append(phase[0].upper() + ':')
            for el in ['all'] + list(self.tasks):
                loss = epoch_losses[phase][el][-1]
                if el == 'all':
                    parts.append(f':{loss:.1f}  ')
                elif el in ('ori', 'aux'):
                    parts.append(f'{el}:{loss:.1f}  ')
                else:
                    parts.append(f'{el}:{loss * 100:.0f}  ')
        print('\r' + ''.join(parts))

    # ------------------------------------------------------------------

    def eval_stats(self, x_cat, y_cat, group_masks):
        """The eval-mode forward over the concatenated rows and, per group
        (a 0/1 row mask), the validation losses and [bi_mean, bi_coverage,
        err_sum, err_sumsq, count, aux_acc]. Returns numpy (G, n_tasks) and
        (G, 6), fetched in one copy."""
        with torch.no_grad():
            with self._precision():
                out = loco_forward(self.params, self.bn_state, x_cat)
            out = out.float()
            dec = extract_outputs(out)
            gt = extract_labels(y_cat)
            errs = torch.abs(dec['d'] - gt['d'])[:, 0]
            bis = dec['bi'][:, 0]
            covered = (errs <= bis).float()
            if 'aux' in self.tasks:
                aux_err = torch.abs((dec['aux'][:, 0] >= 0.5).float() - gt['aux'][:, 0])
            rows = []
            for m in group_masks:
                cnt = m.sum()
                safe = torch.clamp(cnt, min=1.0)
                aux_acc = (1.0 - (aux_err * m).sum() / safe if 'aux' in self.tasks
                           else torch.zeros((), device=x_cat.device))
                rows.append(torch.stack(
                    composite_losses(out, y_cat, self.tasks, phase='val', mask=m)
                    + [(bis * m).sum() / safe, (covered * m).sum() / safe, (errs * m).sum(),
                       ((errs ** 2) * m).sum(), cnt, aux_acc]))
            both = torch.stack(rows).cpu().numpy()
        n_tasks = len(self.tasks)
        return both[:, :n_tasks], both[:, n_tasks:]

    def evaluate(self, load=False, model=None, debug=False):
        if load:
            params, bn_state, _ = load_checkpoint(model, device=self.device)
            self.params, self.bn_state = params, bn_state

        dic_err = defaultdict(lambda: defaultdict(lambda: defaultdict(lambda: 0)))
        dic_err['val']['sigmas'] = [0.] * len(self.tasks)
        dataset = self.datasets['val']
        size_eval = len(dataset)

        if debug:
            # Summary statistics of the shoulder-hip input heights and the
            # labels (headless, no histograms).
            x_dbg, y_dbg = dataset.arrays()
            heights = np.asarray(x_dbg)[:, 11] - np.asarray(x_dbg)[:, 5]
            for name, arr in (('shoulder-hip height', heights),
                              ('labels', np.asarray(y_dbg).ravel())):
                qs = np.percentile(arr, [0, 25, 50, 75, 100])
                print(f"debug {name}: n={arr.size} "
                      f"min/q1/med/q3/max = {np.round(qs, 3).tolist()}")

        # The val set and every non-empty distance cluster, concatenated,
        # with one row mask a group: one forward, one fetch.
        x_va, y_va = dataset.arrays()
        parts_x, parts_y = [x_va], [y_va]
        groups, counts = ['all'], [size_eval]
        for clst in self.clusters:
            inputs, outputs_gt, count = dataset.get_cluster_annotations(clst)
            if count == 0:
                continue
            parts_x.append(np.asarray(inputs))
            parts_y.append(np.asarray(outputs_gt))
            groups.append(clst)
            counts.append(count)
        x_cat = np.concatenate(parts_x, axis=0)
        y_cat = np.concatenate(parts_y, axis=0)
        masks = np.zeros((len(groups), x_cat.shape[0]), np.float32)
        offset = 0
        for g, count in enumerate(counts):
            masks[g, offset:offset + count] = 1.0
            offset += count
        loss_rows, stat_rows = self.eval_stats(
            *(torch.from_numpy(a).to(self.device) for a in (x_cat, y_cat, masks)))
        for g, clst in enumerate(groups):
            self._fill_stats(dic_err['val'], clst, loss_rows[g], stat_rows[g])

        if self.auto_tune_mtl and self.log_sigmas is not None:
            dic_err['val']['sigmas'] = [float(s) for s in
                                        torch.exp(self.log_sigmas.detach()).cpu().numpy()]
        self._cout_stats(dic_err['val'], size_eval, clst='all')
        if self.auto_tune_mtl and self.log_sigmas is not None:
            self.logger.info("Sigmas: " + ", ".join(
                f"{t}: {s:.2f}" for t, s in zip(self.tasks, dic_err['val']['sigmas'])))
        for g in range(1, len(groups)):
            self._cout_stats(dic_err['val'], counts[g], clst=groups[g])

        if not (self.no_save or load):
            self.path_model = self.path_out
            meta = {'mode': self.mode, 'tasks': self.tasks,
                    'hidden_size': self.hidden_size, 'n_stage': self.n_stage,
                    'epoch': getattr(self, 'last_epoch', 0) + 1,
                    'best_val_acc': getattr(self, 'best_acc', None),
                    'best_train_acc': getattr(self, 'best_training_acc', None),
                    'best_epoch': getattr(self, 'best_epoch', None),
                    'version': __version__}
            log_sigmas = (self.log_sigmas.detach().cpu().numpy()
                          if self.log_sigmas is not None else None)
            save_train_state(self.path_model, {
                'params': self.params, 'bn_state': self.bn_state,
                'final_params': getattr(self, 'final_params', self.params),
                'final_bn_state': getattr(self, 'final_bn_state', self.bn_state),
                'log_sigmas': log_sigmas, 'meta': meta,
                'torch_train_state': self.train_state()})
            print('-' * 120)
            self.logger.info("\nmodel saved: {} \n".format(self.path_model))
        else:
            self.logger.info("\nmodel not saved\n")
        return dic_err, (self.params, self.bn_state)

    def _fill_stats(self, dic_err, clst, losses, stats):
        """Unpack one group's row of `eval_stats` into dic_err."""
        for idx, task in enumerate(self.tasks):
            if task == 'aux':
                continue
            dic_err[clst][task] = float(losses[idx])
        bi_mean, bi_cov, err_sum, err_sumsq, n, aux_acc = (float(v) for v in stats)
        dic_err[clst]['bi'] = bi_mean
        dic_err[clst]['bi%'] = bi_cov
        n = int(n)
        if n > 1:
            mean = err_sum / n
            var = max(0.0, (err_sumsq - n * mean * mean) / (n - 1))
            dic_err[clst]['std'] = var ** 0.5
        else:
            dic_err[clst]['std'] = 0.0
        dic_err[clst]['aux'] = 0 if self.mode == 'mono' else aux_acc

    def _cout_stats(self, dic_err, size_eval, clst):
        if clst == 'all':
            print('-' * 120)
            self.logger.info(
                "Evaluation, val set: \nAv. dist D: {:.2f} m with bi {:.2f} ({:.1f}%), \n"
                "X: {:.1f} cm,  Y: {:.1f} cm \nOri: {:.1f}  "
                "\n H: {:.1f} cm, W: {:.1f} cm, L: {:.1f} cm"
                "\nAuxiliary Task: {:.1f} %, ".format(
                    dic_err[clst]['d'], dic_err[clst]['bi'], dic_err[clst]['bi%'] * 100,
                    dic_err[clst]['x'] * 100, dic_err[clst]['y'] * 100,
                    dic_err[clst]['ori'], dic_err[clst]['h'] * 100,
                    dic_err[clst]['w'] * 100, dic_err[clst]['l'] * 100,
                    dic_err[clst]['aux'] * 100))
        else:
            self.logger.info(
                "Val err clust {} --> D:{:.2f}m,  bi:{:.2f} ({:.1f}%), STD:{:.1f}m   "
                "X:{:.1f} Y:{:.1f}  Ori:{:.1f}d,   H: {:.0f} W: {:.0f} L:{:.0f}  for {} pp. ".format(
                    clst, dic_err[clst]['d'], dic_err[clst]['bi'], dic_err[clst]['bi%'] * 100,
                    dic_err[clst]['std'], dic_err[clst]['x'] * 100, dic_err[clst]['y'] * 100,
                    dic_err[clst]['ori'], dic_err[clst]['h'] * 100,
                    dic_err[clst]['w'] * 100, dic_err[clst]['l'] * 100, size_eval))

    def _print_losses(self, epoch_losses):
        try:
            import matplotlib.pyplot as plt
        except ImportError:
            raise Exception('please install matplotlib')
        os.makedirs(self.dir_figures, exist_ok=True)
        for idx, phase in enumerate(epoch_losses):
            for idx_2, el in enumerate(epoch_losses['train']):
                plt.figure(idx + idx_2)
                plt.title(phase + '_' + el)
                plt.xlabel('epochs')
                plt.plot(epoch_losses[phase][el][10:], label=f'{phase} Loss: {el}')
                plt.savefig(os.path.join(self.dir_figures, f'{phase}_loss_{el}.png'))
                plt.close()

    def _set_logger(self, args):
        if self.no_save:
            logging.basicConfig(level=logging.INFO)
            self.logger = logging.getLogger(__name__)
        else:
            self.path_model = self.path_out
            print(self.path_model)
            self.logger = set_logger(os.path.splitext(self.path_out)[0])
            self.logger.info(
                f'\nVERSION: {__version__}\n'
                f'\nINPUT_FILE: {args.joints}'
                f'\nInput file version: {self.dataset_version}\n'
                f'\nTraining arguments:'
                f'\nmode: {self.mode} \nlearning rate: {args.lr} \nbatch_size: {args.bs}'
                f'\nepochs: {args.epochs} \ndropout: {args.dropout} '
                f'\nscheduler step: {args.sched_step} \nscheduler gamma: {args.sched_gamma} '
                f'\ninput_size: {self.input_size[self.mode]} '
                f'\noutput_size: {self.output_size[self.mode]} '
                f'\nhidden_size: {args.hidden_size}'
                f' \nn_stages: {args.n_stage} \n r_seed: {args.r_seed} '
                f'\nlambdas: {self.lambdas}'
            )
