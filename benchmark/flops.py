"""Operations the traffic asks of the network, from the configuration's
widths: the yardstick of the roofline and MFU shares.

A row of the MLP is 2 x (in H + (2 S + 2) H^2 + H out) operations: the
input layer, two H x H layers a residual stage, `w2` and `w3`, and the two
heads (`w_fin`, out - 1 wide, and `w_aux`, 1 wide). BatchNorm, the ReLUs,
biases and the decode are not counted. Only useful rows count: a mono
chunk's detections, a stereo chunk's left x right pairs of each frame, each
(1 + n_dropout) times with MC dropout. Rows padded to the engine's buckets
are not counted, so padding shows as a lower share.
"""

import json
from pathlib import Path

from benchmark.reference.loco_mlp import bucket

PEAKS_FILE = Path(__file__).resolve().parent / 'peaks.json'


def ops_per_row(cfg):
    i, h, o, s = cfg['input_size'], cfg['linear_size'], cfg['output_size'], cfg['num_stage']
    return 2 * (i * h + (2 * s + 2) * h * h + h * o)


def useful_rows(chunk, n_dropout=0):
    """The MLP rows a chunk needs: sum L (mono) or sum L x R (stereo), times
    1 + n_dropout."""
    if 'counts_r' in chunk:
        rows = sum(a * b for a, b in zip(chunk['counts'], chunk['counts_r']))
    else:
        rows = sum(chunk['counts'])
    return rows * (1 + n_dropout)


def padded_rows(chunk, n_dropout=0):
    """The rows the engine computes for a chunk: images and detections
    padded to powers of two (at least 1 image, 4 detections), stereo's
    right detections apart; the MC passes on the padded bucket."""
    images = bucket(len(chunk['counts']), 1)
    rows = images * bucket(max(chunk['counts']), 4)
    if 'counts_r' in chunk:
        rows *= bucket(max(chunk['counts_r']), 4)
    return rows * (1 + n_dropout)


def chunk_ops(cfg, chunk, n_dropout=0):
    return ops_per_row(cfg) * useful_rows(chunk, n_dropout)


def peak(precision):
    """(published dense peak in operations/s, its source) of one H100 SXM
    for a serving precision."""
    table = json.loads(PEAKS_FILE.read_text())
    entry = table['precisions'][precision]
    return float(entry['ops_per_s']), entry['name']
