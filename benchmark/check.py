"""The comparison that decides `correct`: the program's outputs of sampled
chunks against the plain reference, after the window.

The program returns decoded quantities; their inverse gives back the
network's raw channels, which the reference computes and decodes in float64
and recovers the same way: theta = atan2(z, x sign(d)) (z is |d sin(psi)
sin(theta)|, so theta comes back folded into [0, pi]), psi = acos(y / d), d, log-spread = log(b / d), h, w, l, the
yaw's sin and cos, the yaw itself, the yaw recovered from the egocentric one
(yaw_ego - atan2(x, z)), and for stereo the aux logit (logit of the aux
probability). A wrong decode of x, y, z, b or the yaws moves a recovered
channel as a wrong MLP does. Each channel's error is in units of that
channel's spread over the traffic (`output_std` of the configuration; the
two yaws are angles, so their error is the angle times the reference's
(sin, cos) length, over the mean of the sin and cos spreads): the
quantization noise of a channel is then about the same size whatever its
unit.

The reference is float32 (TF32 off), or, where `limits/<workload>.json`
names `"reference": "bf16"`, the arithmetic a bfloat16 cell states
(`reference/loco_mlp.py` `mlp`): against float32, the bfloat16 rounding of
the input projection's operands is most of a bfloat16 program's error and
of an int8 one's alike, so only the stated arithmetic tells the two apart.

Numbers compared, each against its limit in `limits/<workload>.json`:

- `rows_missing`: frames whose outputs are absent or have another number
  of rows than the frame has detections, plus left poses whose chosen right
  pose is not one of the frame's (exact: limit 0);
- `raw_err`: the largest such channel error over every compared detection.
  For stereo the reference's channels are those of the pairing the program
  chose;
- `raw_err_mean`: each compared detection's largest channel error, averaged
  over the detections: steady from seed to seed where the largest is set by
  the rarest rounding, so it parts a precision from the next where
  `raw_err` does not (bfloat16 from its int8 control);
- `aux_gap` (stereo): the largest amount by which the reference's aux logit
  of the right pose the program chose lies below the reference's best for
  that left pose; 0 where they chose alike;
- `aux_gap_mean` (stereo): that amount's mean over every compared left
  pose: it grows with the square of the noise (how often a near tie flips,
  times by how much), so it parts one precision from the next where the
  largest, set by the rarest near tie, does not;
- `epi_err` (MC dropout): the largest |program - reference| / (1 +
  |reference|) of the epistemic std, in metres.
"""

import importlib
import math

import numpy as np
import torch

YAW_CHANNELS = ('yaw', 'yaw_ego')


def recover_raw(out):
    """One frame's program output dict -> ({channel: (m,) float64}, epi (m,),
    aux_idx (m,) or None)."""
    def col(key, j=0):
        return np.asarray(out[key], np.float64).reshape(len(out['d']), -1)[:, j]

    x, y, z, d = (col('xyzd', j) for j in range(4))
    with np.errstate(divide='ignore', invalid='ignore'):
        raw = {'theta': np.arctan2(z, x * np.sign(d)), 'psi': np.arccos(np.clip(y / d, -1.0, 1.0)), 'd': d,
               'log_spread': np.log(col('bi') / d), 'h': col('h'), 'w': col('w'),
               'l': col('l'), 'sin': col('ori', 0), 'cos': col('ori', 1),
               'yaw': np.asarray(out['yaw'][0], np.float64).reshape(-1),
               'yaw_ego': (np.asarray(out['yaw'][1], np.float64).reshape(-1)
                           - np.arctan2(x, z))}
        if 'aux' in out:
            p = col('aux')
            raw['aux'] = np.log(p / (1.0 - p))
    aux_idx = (np.asarray(out['aux_idx']).reshape(-1).astype(np.int64)
               if 'aux_idx' in out else None)
    return raw, np.asarray(out['epi'], np.float64).reshape(-1), aux_idx


def _reference(cfg):
    return importlib.import_module(f"benchmark.reference.{cfg['reference']}")


def _layout(dec, sl=slice(None)):
    """The reference's decoded dict (`decode`) over rows `sl`, in
    `finalize()`'s layout."""
    out = {'xyzd': np.stack([dec['x'][sl], dec['y'][sl], dec['z'][sl], dec['d'][sl]], 1),
           'd': dec['d'][sl, None], 'bi': dec['bi'][sl, None], 'h': dec['h'][sl, None],
           'w': dec['w'][sl, None], 'l': dec['l'][sl, None],
           'ori': np.stack([dec['sin'][sl], dec['cos'][sl]], 1),
           'yaw': (dec['yaw'][sl, None], dec['yaw_ego'][sl, None])}
    if 'aux' in dec:
        out['aux'] = dec['aux'][sl, None]
    return out


def reference_channels(ref, raw):
    """Raw reference outputs (n, 9|10) float64 -> {channel: (n,)}, decoded
    (float64) and recovered as the program's outputs are: theta and psi come
    back folded into what the decode can express (z >= 0 keeps only
    |sin(theta)|), alike on both sides."""
    dec = ref.decode(torch.from_numpy(raw))
    out = _layout(dec)
    out['epi'] = np.zeros(len(raw))
    ch = recover_raw(out)[0]
    if raw.shape[1] == 10:
        ch['aux'] = raw[:, 9]
    return ch


def raw_err(prog, ref, std):
    """(The largest channel error in units of the channel's spread, its
    channel, each detection's largest channel error (n,))."""
    worst, where = 0.0, None
    per_det = np.zeros(len(next(iter(ref.values()))))
    spread = {n: s for n, s in zip(['theta', 'psi', 'd', 'log_spread', 'h', 'w', 'l', 'sin',
                                    'cos', 'aux'], std)}
    ori = 0.5 * (spread['sin'] + spread['cos'])
    length = np.hypot(ref['sin'], ref['cos'])
    for name, r in ref.items():
        diff = prog[name] - r
        if name in YAW_CHANNELS:
            diff = np.arctan2(np.sin(diff), np.cos(diff)) * length / ori
        else:
            diff = diff / spread[name]
        err = np.where(np.isfinite(diff), np.abs(diff), np.inf)
        per_det = np.maximum(per_det, err)
        if err.size:
            top = float(np.max(err))
            if top > worst:
                worst, where = top, name
    return worst, where, per_det


class Numbers:
    """Running maxima of the compared numbers over the sampled chunks."""

    def __init__(self, stereo, mc):
        self.values = {'rows_missing': 0, 'raw_err': 0.0, 'raw_err_mean': 0.0}
        self._err_sum = 0.0
        if stereo:
            self.values['aux_gap'] = 0.0
            self.values['aux_gap_mean'] = 0.0
            self._gap_sum = 0.0
        if mc:
            self.values['epi_err'] = 0.0
        self.frames = self.detections = 0
        self.raw_err_channel = None
        self.epi_worst = None     # (program, reference, the detection's place in its frame)

    def worst(self, key, value):
        self.values[key] = max(self.values[key], value)


def _frames_ok(outs, chunk, numbers):
    """[(frame, recovered)] of the frames whose output has the right shape;
    the others count as missing."""
    ok = []
    n_frames = len(chunk['counts'])
    if outs is None or len(outs) != n_frames:
        numbers.values['rows_missing'] += 1
    for f, m in enumerate(chunk['counts']):
        out = outs[f] if outs is not None and f < len(outs) else None
        if out is None or len(out.get('d', ())) != m:
            numbers.values['rows_missing'] += 1
        else:
            ok.append((f, recover_raw(out)))
    return ok


def _offsets(counts):
    return np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int64)


def compare_chunk(cfg, traffic, weights, chunk, outs, device, numbers, ref_mode='f32'):
    """Fold one chunk's program outputs `outs` (a list, one dict a frame, as
    `finalize()` returns them) into `numbers`, against the reference in
    `ref_mode` (the MC std: always float32, which every precision serves)."""
    frames = _frames_ok(outs, chunk, numbers)
    if not frames:
        return
    plain = _reference(cfg)
    off = _offsets(chunk['counts'])
    if 'counts_r' in chunk:
        grid, _ = plain.stereo_chunk(weights, chunk, device, ref_mode)
        ref_rows, valid_all = [], []
        for f, (_, _, idx) in frames:
            valid = (idx >= 0) & (idx < chunk['counts_r'][f])
            numbers.values['rows_missing'] += int((~valid).sum())
            lefts = off[f] + np.arange(len(idx))
            pick = np.where(valid, idx, 0)
            aux = grid[lefts, :, -1]
            gap = np.nanmax(aux, axis=1) - aux[np.arange(len(idx)), pick]
            gap = np.where(valid, gap, 0.0)
            numbers.worst('aux_gap', float(np.max(gap, initial=0.0)))
            numbers._gap_sum += float(gap.sum())
            ref_rows.append(grid[lefts, pick])
            valid_all.append(valid)
        valid = np.concatenate(valid_all)
        ref = reference_channels(plain, np.concatenate(ref_rows)[valid])
    else:
        sel = np.concatenate([off[f] + np.arange(chunk['counts'][f]) for f, _ in frames])
        x = plain.normalize(plain.cat_frames(chunk['left'], device),
                            plain.kk_rows(chunk['kk'], chunk['counts'], device))
        raw = plain.mlp(weights, x, ref_mode).double().cpu().numpy()
        ref = reference_channels(plain, raw[sel])
        valid = np.ones(len(sel), bool)
        if traffic.get('n_dropout', 0) > 0:
            epi = plain.mc_epistemic(weights, chunk, device, traffic['n_dropout'],
                                     cfg['p_dropout'])[sel]
            prog_epi = np.concatenate([rec[1] for _, rec in frames])
            err = np.abs(prog_epi - epi) / (1.0 + np.abs(epi))
            i = int(np.argmax(np.where(np.isfinite(err), err, np.inf)))
            if err[i] > numbers.values['epi_err']:
                numbers.values['epi_err'] = float(err[i])
                numbers.epi_worst = [float(prog_epi[i]), float(epi[i]), int(sel[i] - off[
                    np.searchsorted(off, sel[i], side='right') - 1])]
    prog = {k: np.concatenate([rec[0][k] for _, rec in frames])[valid] for k in ref}
    err, channel, per_det = raw_err(prog, ref, cfg['output_std'])
    if err > numbers.values['raw_err']:
        numbers.values['raw_err'], numbers.raw_err_channel = err, channel
    numbers.frames += len(frames)
    numbers.detections += int(valid.sum())
    numbers._err_sum += float(per_det.sum())
    numbers.values['raw_err_mean'] = numbers._err_sum / max(numbers.detections, 1)
    if 'aux_gap_mean' in numbers.values:
        numbers.values['aux_gap_mean'] = numbers._gap_sum / max(numbers.detections, 1)


def reference_outputs(cfg, traffic, weights, chunk, device, mode):
    """The reference at `mode` in the program's place: one output dict a
    frame, in `finalize()`'s layout (the controls)."""
    plain = _reference(cfg)
    counts = chunk['counts']
    off = _offsets(counts)
    epi = None
    if 'counts_r' in chunk:
        grid, best = plain.stereo_chunk(weights, chunk, device, mode)
        raw = grid[np.arange(len(best)), best]
    else:
        x = plain.normalize(plain.cat_frames(chunk['left'], device),
                            plain.kk_rows(chunk['kk'], counts, device))
        raw = plain.mlp(weights, x, mode).double().cpu().numpy()
        if traffic.get('n_dropout', 0) > 0:
            epi = plain.mc_epistemic(weights, chunk, device, traffic['n_dropout'],
                                     cfg['p_dropout'], mode)
    dec = plain.decode(torch.from_numpy(raw).float())
    outs = []
    for f, m in enumerate(counts):
        sl = slice(off[f], off[f] + m)
        out = _layout(dec, sl)
        out['epi'] = np.zeros(m) if epi is None else epi[sl]
        if 'aux' in dec:
            out['aux_idx'] = best[sl]
        outs.append(out)
    return outs


def judge(values, limits):
    """(correct, [(name, value, limit)]) for the numbers a cell's limits
    name (a cell compares those whose control parts them from a sound run;
    the others are printed with the run's counts)."""
    rows = [(k, values[k], limits[k]) for k in limits]
    ok = all(math.isfinite(v) and v <= lim for _, v, lim in rows)
    return ok, rows
