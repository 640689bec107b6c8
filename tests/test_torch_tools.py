"""The port's tools cover the JAX package's `tools/`.

Every `tools/*.py` of the repository needs one of: a port at
`monoloco_tpu_torch/tools/<same name>.py`; a `COUNTERPART` entry naming the
file that does its work for the port; or a `NOT_PORTED_TOOLS` entry with its
reason. An entry goes stale, and fails the test, when the tool no longer
exists, when the port now has a module of that name, or when a counterpart
file does not exist. A new `tools/*.py` with none of the three fails too.

Alone: python -m pytest tests/test_torch_tools.py -q
"""

import ast
import os

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
JAX_TOOLS = os.path.join(REPO, 'tools')
PORT_TOOLS = os.path.join(REPO, 'monoloco_tpu_torch', 'tools')

# Tool -> the file of the repository that does its work for the port.
COUNTERPART = {
    'int8_eval_parity': 'monoloco_tpu_torch/tools/eval_parity.py',
    'head_to_head': 'monoloco_tpu_torch/tools/eval_parity.py',   # --train, JAX_REFERENCE
    'parity_check': 'tests/test_torch_export.py',
}
_STORAGE = ("bf16 weight storage resolves to f32 off the TPU, in the JAX package "
            "(`utils/precision.py:72`) and in the port (`serve_storage()`), so there is "
            "nothing to measure (ROADMAP Queue 1 item 3)")
NOT_PORTED_TOOLS = {
    'bench_serve_storage': _STORAGE,
    'serve_storage_eval_parity': _STORAGE,
    'h2h_summarize': "host code over a results JSONL that imports no framework "
                     "(json, statistics), so it runs as it is beside the port",
    'make_fixtures': "reads the reference checkout and Pillow to write the JAX package's "
                     "pre-port test fixtures, which the port's tests read unchanged",
    'make_reference_goldens': "needs the reference's virtual environment and writes the "
                              "pre-port goldens under tests/goldens/byte_compat/",
    'crossval_kitti_eval': "builds the reference's C++ devkit and the repository's and "
                           "compares their statistics: C++ against C++, no framework",
}
# The drivers this repository requires as ports, never as entries above.
MUST_PORT = {'bench_variance', 'bench_generate_full_scale', 'bench_cli_phases',
             'bench_hyp_search', 'bench_mesh_scaling', 'bench_int8_roofline',
             'train_tiny_reid'}


def _tools(path):
    return sorted(f[:-3] for f in os.listdir(path) if f.endswith('.py') and f != '__init__.py')


JAX_TOOL_NAMES = _tools(JAX_TOOLS)


@pytest.mark.parametrize('tool', JAX_TOOL_NAMES)
def test_tool_has_a_port_a_counterpart_or_a_reason(tool):
    ported = os.path.exists(os.path.join(PORT_TOOLS, tool + '.py'))
    listed = [table for table, entries in (('COUNTERPART', COUNTERPART),
                                           ('NOT_PORTED_TOOLS', NOT_PORTED_TOOLS))
              if tool in entries]
    assert ported or listed, f"tools/{tool}.py has no port, counterpart or reason"
    assert not (ported and listed), f"tools/{tool}.py is ported and also in {listed}"
    assert len(listed) <= 1, f"tools/{tool}.py is in both tables"


def test_entries_are_current():
    stale = []
    for tool, target in COUNTERPART.items():
        if tool not in JAX_TOOL_NAMES:
            stale.append((tool, 'no such tool'))
        if not os.path.exists(os.path.join(REPO, target)):
            stale.append((tool, f'no counterpart {target}'))
    for tool, reason in NOT_PORTED_TOOLS.items():
        assert reason.strip(), tool
        if tool not in JAX_TOOL_NAMES:
            stale.append((tool, 'no such tool'))
        if os.path.exists(os.path.join(PORT_TOOLS, tool + '.py')):
            stale.append((tool, 'the port has it'))
    assert not stale, stale


def test_required_drivers_are_ports():
    assert MUST_PORT <= set(JAX_TOOL_NAMES)
    assert not MUST_PORT & (set(COUNTERPART) | set(NOT_PORTED_TOOLS))
    missing = [t for t in sorted(MUST_PORT) if not os.path.exists(
        os.path.join(PORT_TOOLS, t + '.py'))]
    assert not missing, missing


@pytest.mark.parametrize('tool', _tools(PORT_TOOLS))
def test_port_tool_is_a_driver(tool):
    """Every port tool runs as `python -m` (a `main` and the `__main__`
    guard), and one with a JAX namesake names that tool in its docstring."""
    with open(os.path.join(PORT_TOOLS, tool + '.py')) as f:
        source = f.read()
    tree = ast.parse(source)
    assert "if __name__ == '__main__':" in source, tool
    assert any(isinstance(n, ast.FunctionDef) and n.name == 'main' for n in tree.body), tool
    if tool in JAX_TOOL_NAMES:
        doc = ast.get_docstring(tree) or ''
        assert f'tools/{tool}.py' in doc.replace('\n', ' '), tool


def test_the_walk_sees_the_tools():
    assert len(JAX_TOOL_NAMES) >= 24
    assert {'bench_roofline', 'make_synthetic_kitti', 'export_torch'} <= set(JAX_TOOL_NAMES)
