"""chip_smoke's output helpers on the CPU: what survives the end of its output.

- `_cli` runs the CLI's entry point in-process with its stdout, stderr and
  logging kept back, prints one line in their place, and leaves the logging
  handlers' streams as they were; a failure, a SystemExit included, prints
  the kept tail and re-raises.
- `banner`, `record`, `tally` and `phases_line`: each phase's wall from its
  banner to the next, its main-path launches by kernel and its records, in
  one JSON line of at most 8 KB.

Alone: python -m pytest tests/test_torch_chip_smoke.py -q
"""

import importlib.util
import json
import logging
import os
import shutil

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
MODEL = os.path.join(HERE, 'goldens', 'byte_compat', 'model_tpu.pkl')


@pytest.fixture
def chip_smoke():
    """A fresh copy of the script's module (its summary state is module-level)."""
    spec = importlib.util.spec_from_file_location('chip_smoke_under_test',
                                                  os.path.join(REPO, 'chip_smoke.py'))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _images(tmp_path, n):
    for i in range(n):
        dst = tmp_path / f'im{i}.png'
        shutil.copy(os.path.join(HERE, 'fixture_002282.png'), dst)
        shutil.copy(os.path.join(HERE, 'fixture_002282.pifpaf.json'), f'{dst}.pifpaf.json')


def test_cli_keeps_a_predict_run_back(chip_smoke, tmp_path, capsys):
    _images(tmp_path, 3)
    handler = logging.StreamHandler()                 # bound to the current stderr
    logging.getLogger('chip_smoke_test').addHandler(handler)
    stream = handler.stream
    try:
        net = chip_smoke._cli(['predict', '--glob', str(tmp_path / '*.png'), '--model', MODEL,
                               '--calibration', 'kitti', '--output_types', 'json', '-o',
                               str(tmp_path / 'out'), '--disable-cuda'])
    finally:
        logging.getLogger('chip_smoke_test').removeHandler(handler)
    out, err = capsys.readouterr()
    assert net.n_dispatches == 1 and len(os.listdir(tmp_path / 'out')) == 3
    assert out.count('\n') == 1 and out.startswith('  [run predict --glob: ')
    assert 'kept back' in out and 'saved' not in out and err == ''
    assert handler.stream is stream


def test_cli_prints_the_kept_tail_when_the_run_fails(chip_smoke, tmp_path, capsys):
    with pytest.raises(SystemExit):
        chip_smoke._cli(['train', '--joints', str(tmp_path / 'missing.json'), '--disable-cuda'])
    out = capsys.readouterr().out
    assert '[run train --joints: ' in out
    with pytest.raises(SystemExit):               # argparse writes to stderr, then exits
        chip_smoke._cli(['train', '--disable-cuda'])
    out = capsys.readouterr().out
    assert 'the following arguments are required: --joints' in out
    assert '[run train --disable-cuda: ' in out
    with pytest.raises(FileNotFoundError):
        with chip_smoke._captured('a failing block'):
            print('the line before the failure')
            open(tmp_path / 'missing')
    out = capsys.readouterr().out
    assert 'the line before the failure' in out and '[a failing block: 1 lines' in out


def test_phases_line_carries_walls_launches_and_records(chip_smoke, capsys):
    launches = {}
    for phase in ('1', '7b', '34', '7b'):
        chip_smoke.banner(f"== phase {phase}: rehearsal", flush=True)
        if phase == '7b':
            chip_smoke.tally(launches, phase, {'relu_chain_bf16': 8, 'dyn8_mlp': 0})
            chip_smoke.tally(launches, phase, {'relu_chain_bf16': 2})
            chip_smoke.record({'phase': phase, 'ms': 1.0})
    chip_smoke.banner("not a phase")
    line = chip_smoke.phases_line()
    assert len(line) <= chip_smoke.SUMMARY_MAX_BYTES
    entries = json.loads(line)['phases']
    assert [e['phase'] for e in entries] == [1, '7b', 34]          # a phase's banners summed
    assert entries[1]['launches'] == {'relu_chain_bf16': 20} and entries[1]['records'] == 2
    assert entries[0]['launches'] == {} and all(e['wall_s'] >= 0 for e in entries)
    assert launches == {'relu_chain_bf16': 20}
    assert '{"phase": "7b", "ms": 1.0}' in capsys.readouterr().out


def test_phases_line_of_34_phases_fits(chip_smoke):
    kernels = ('dyn8_mlp', 'fused_mlp_bf16', 'fused_mlp_f32', 'int8_static_mlp', 'w8_mlp',
               'relu_chain_bf16')
    for phase in list(range(1, 35)) + ['7b']:
        chip_smoke.banner(f"== phase {phase}: x")
        chip_smoke.tally({}, phase, {k: 12345 for k in kernels})
    assert len(chip_smoke.phases_line()) <= chip_smoke.SUMMARY_MAX_BYTES
