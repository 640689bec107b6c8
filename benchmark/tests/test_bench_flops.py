"""The operation counts against hand counts, and the rows they count."""

from benchmark import flops, manifest


def _config(name):
    return manifest.resolve({'monstereo': 'monstereo-crowd-int8',
                             'monoloco_pp': 'monoloco_pp-mc10-f32'}[name])['config']


def test_ops_per_row_by_hand():
    # MonStereo: 68 x 1024 in, 8 H x H layers (3 stages x 2, w2, w3), heads 1024 x (9 + 1).
    assert flops.ops_per_row(_config('monstereo')) == 2 * (68 * 1024 + 8 * 1024 ** 2 + 1024 * 10)
    assert flops.ops_per_row(_config('monstereo')) == 16_936_960
    # MonoLoco++: 34 in, 9 out (8 from w_fin, 1 from w_aux).
    assert flops.ops_per_row(_config('monoloco_pp')) == 2 * (34 * 1024 + 8 * 1024 ** 2 + 1024 * 9)
    assert flops.ops_per_row(_config('monoloco_pp')) == 16_865_280


def test_useful_and_padded_rows():
    mono = {'counts': [3, 5, 17]}
    assert flops.useful_rows(mono) == 25
    assert flops.useful_rows(mono, n_dropout=10) == 275
    assert flops.padded_rows(mono) == 4 * 32                 # 3 images -> 4, 17 -> 32
    assert flops.padded_rows(mono, n_dropout=10) == 11 * 4 * 32
    stereo = {'counts': [2, 3], 'counts_r': [1, 4]}
    assert flops.useful_rows(stereo) == 2 * 1 + 3 * 4
    assert flops.padded_rows(stereo) == 2 * 4 * 4
    assert flops.chunk_ops(_config('monstereo'), stereo) == 14 * 16_936_960


def test_peaks_are_the_published_dense_rates():
    assert flops.peak('int8')[0] == 1979e12
    assert flops.peak('bf16')[0] == 989e12
    assert flops.peak('default')[0] == 67e12
