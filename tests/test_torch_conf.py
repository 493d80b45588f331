"""The port's conf loader against the JAX package's.

The port parses the scheduler conf without a YAML library (the machine
with the card has none); on every conf the repo ships and every conf
string the allocate parity suites use, it must give the JAX parser's
`SchedulerConfiguration` field for field, and it must refuse YAML outside
the schema's subset, naming the line.

The cases of tests/test_conf.py have twins of the same name at the end of
this file (TestConfParse's six, TestRound1Fixes's six), each run on both
packages with equal readings; the port's conf names ``torch_allocate``
where the JAX conf names ``xla_allocate``.
"""

import ast
import dataclasses
import glob
import os
import subprocess
import sys

import pytest

from kube_batch_tpu.conf import parse_scheduler_conf as jax_parse

from kube_batch_tpu_torch import actions  # noqa: F401  (registers the port's actions)
from kube_batch_tpu_torch import conf as torch_conf
from kube_batch_tpu_torch.conf import load_scheduler_conf, parse_scheduler_conf

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _module_confs(path):
    """Every module-level or function-level string constant in a test file
    that parses as a scheduler conf (it names tiers)."""
    with open(path) as f:
        tree = ast.parse(f.read())
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) and "tiers:" in node.value:
            out.append(node.value)
    return out


CONFS = {
    os.path.relpath(p, ROOT): open(p).read() for p in sorted(glob.glob(os.path.join(ROOT, "examples", "*.yaml")))
}
for test_file in ("tests/test_xla_allocate.py", "tests/test_torch_allocate.py"):
    for i, text in enumerate(_module_confs(os.path.join(ROOT, test_file))):
        CONFS[f"{test_file}#{i}"] = text

# The rest of the schema: every enable flag, arguments with YAML 1.1's
# implicit types (ints, floats, booleans, null, sexagesimal, octal, hex),
# quoted scalars with escapes, comments, top-level scalars, and
# actionArguments with an empty entry.
CONFS["full_schema"] = """
# a conf that reaches every part of the schema
actions: 'torch_allocate, backfill'   # trailing comment
faults: ""
streaming: on
trace: off
explain: yes
fleet: "http://a:1, http://b:2"
actionArguments:
  torch_allocate:
    device: cpu
    mesh: cpu:4
    min_device_pairs: 0
    exchange_batch: 4
  backfill:
tiers:
- plugins:
  - name: priority
    enableJobOrder: false
    enableTaskOrder: "false"
  - name: gang
    enableJobReady: no
    enableJobPipelined: 0
  - name: conformance
    enablePreemptable: true
    enableReclaimable: ~
- plugins:
  - name: drf
    enableQueueOrder: Off
  - name: predicates
    enablePredicate: YES
  - name: proportion
  - name: nodeorder
    enableNodeOrder: 1
    arguments:
      leastrequested.weight: 2
      balancedresource.weight: 1.50
      nodeaffinity.weight: 0x10
      podaffinity.weight: 010
      a: 1:30
      b: -3
      c: .5
      d: 1e3
      e: null
      f: "esc\\taped \\"q\\""
      g: 'it''s'
      h: "#not a comment"
"""


def _as_dict(conf):
    return dataclasses.asdict(conf)


@pytest.mark.parametrize("name", sorted(CONFS))
def test_parse_matches_the_jax_parser(name):
    text = CONFS[name]
    want = _as_dict(jax_parse(text))
    got = _as_dict(parse_scheduler_conf(text))
    assert got == want


def test_the_port_conf_is_among_the_examples():
    conf = parse_scheduler_conf(CONFS["examples/scheduler-conf-torch.yaml"])
    assert conf.actions == "torch_allocate, backfill"
    assert [[p.name for p in t.plugins] for t in conf.tiers] == [
        ["priority", "gang", "conformance"], ["drf", "predicates", "proportion", "nodeorder"],
    ]


def test_load_rejects_an_unknown_action():
    with pytest.raises(ValueError, match="failed to find Action 'no_such_action'"):
        load_scheduler_conf('actions: "torch_allocate, no_such_action"\ntiers:\n- plugins:\n  - name: gang\n')


def test_load_resolves_the_port_actions():
    actions_, tiers, args = load_scheduler_conf(CONFS["examples/scheduler-conf-torch.yaml"])
    assert [a.name for a in actions_] == ["torch_allocate", "backfill"]
    assert type(actions_[0]).__module__ == "kube_batch_tpu_torch.actions.torch_allocate"
    assert len(tiers) == 2 and args == {}


@pytest.mark.parametrize(
    "text, line",
    [
        ("actions: allocate\ntiers: [{plugins: []}]\n", 2),  # flow collection
        ("tiers:\n- plugins: {name: gang}\n", 2),
        ("actions: &a allocate\n", 1),  # anchor
        ("actions: *a\n", 1),  # alias
        ("actions: !!str allocate\n", 1),  # tag
        ("actions: |\n  allocate\n", 1),  # block scalar
        ("---\nactions: allocate\n", 1),  # documents
        ("actions: allocate\ntiers:\n\t- plugins:\n", 3),  # tab indentation
        ("actions: allocate\n  tiers:\n", 2),  # bad indentation
        ("tiers:\n- plugins:\n  - name: gang\n   arguments:\n", 4),
        ("actions: \"allocate\n", 1),  # unterminated quote
        ("actions: a: b\n", 1),  # a mapping inside a plain scalar
        ("tiers: gang\n", 1),  # tiers is not a list
        ("tiers:\n- plugins: gang\n", 2),  # plugins is not a list
        ("tiers:\n- gang\n", 2),  # a tier is not a mapping
        ("actionArguments:\n  torch_allocate: cuda\n", 2),  # not a mapping of mappings
        ("actionArguments:\n  torch_allocate:\n    mesh:\n      n: 4\n", 3),
        ("tiers:\n- plugins:\n  - name: nodeorder\n    arguments:\n      w:\n      - 1\n", 5),
        ("just a scalar\n", 1),
        ("- a list\n", 1),
    ],
)
def test_yaml_outside_the_subset_raises_naming_the_line(text, line):
    with pytest.raises(ValueError, match=rf"^line {line}:"):
        parse_scheduler_conf(text)


def test_plain_scalars_resolve_as_yaml_does():
    import yaml

    for text in ("1", "-3", "+7", "010", "0x1F", "0b101", "1_000", "1:30", "1.5", "-.5", ".inf", "-.Inf",
                 "1e3", "1.0e+3", "190:20:30.15", "true", "Off", "YES", "n", "~", "null", "cpu:4", "auto",
                 "0.0.1", "12:60", "abc"):
        want = yaml.safe_load(f"k: {text}")["k"]
        got = torch_conf._load(f"k: {text}")["k"]
        assert type(got) is type(want) and (got == want or (got != got and want != want)), text


def test_the_conf_module_does_not_import_yaml():
    """No import of yaml in the module's source, and loading it in a
    fresh interpreter with yaml blocked works."""
    path = torch_conf.__file__
    with open(path) as f:
        tree = ast.parse(f.read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module]
    assert not [n for n in names if n == "yaml" or n.startswith("yaml.")]
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name == 'yaml' or name.startswith('yaml.'):\n"
        "            raise ImportError('yaml imported')\n"
        "sys.meta_path.insert(0, Block())\n"
        "from kube_batch_tpu_torch.scheduler import Scheduler\n"
        "from kube_batch_tpu_torch.conf import parse_scheduler_conf\n"
        "c = parse_scheduler_conf(open('examples/scheduler-conf-torch.yaml').read())\n"
        "assert c.actions == 'torch_allocate, backfill'\n"
        "assert 'yaml' not in sys.modules\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


# -- twins of tests/test_conf.py ----------------------------------------------


def _pkg(root: str):
    import importlib
    import types

    conf = importlib.import_module(f"{root}.conf")
    importlib.import_module(f"{root}.actions")  # registers the package's actions
    return types.SimpleNamespace(
        conf=conf, helpers=importlib.import_module(f"{root}.api.helpers"),
        resource=importlib.import_module(f"{root}.api.resource_info"),
        types=importlib.import_module(f"{root}.api.types"), testing=importlib.import_module(f"{root}.testing"),
        device_action="xla_allocate" if root == "kube_batch_tpu" else "torch_allocate",
    )


JAX_PKG, PORT_PKG = _pkg("kube_batch_tpu"), _pkg("kube_batch_tpu_torch")


def both(case):
    want, got = case(JAX_PKG), case(PORT_PKG)
    assert got == want
    return got


class TestConfParse:
    def test_default_conf(self):
        def case(P):
            actions_list, tiers, action_args = P.conf.load_scheduler_conf(P.conf.DEFAULT_SCHEDULER_CONF)
            assert action_args == {}
            assert [a.name for a in actions_list] == ["allocate", "backfill"]
            assert len(tiers) == 2
            assert [p.name for p in tiers[0].plugins] == ["priority", "gang"]
            assert [p.name for p in tiers[1].plugins] == ["drf", "predicates", "proportion", "nodeorder"]
            return [[dataclasses.asdict(p) for p in t.plugins] for t in tiers]

        both(case)

    def test_enable_flags_default_true(self):
        def case(P):
            conf = P.conf.parse_scheduler_conf(P.conf.DEFAULT_SCHEDULER_CONF)
            for tier in conf.tiers:
                for option in tier.plugins:
                    assert option.enabled_job_order is True
                    assert option.enabled_predicate is True
            return _as_dict(conf)

        both(case)

    def test_explicit_flag_respected(self):
        text = """
actions: "allocate"
tiers:
- plugins:
  - name: gang
    enableJobOrder: false
    arguments:
      foo: "7"
"""

        def case(P):
            option = P.conf.parse_scheduler_conf(text).tiers[0].plugins[0]
            assert option.enabled_job_order is False
            assert option.enabled_job_ready is True
            assert option.arguments == {"foo": "7"}
            return dataclasses.asdict(option)

        both(case)

    def test_action_arguments_parsed(self):
        def case(P):
            conf = P.conf.parse_scheduler_conf(
                f'actions: "enqueue, {P.device_action}, backfill"\n'
                f"actionArguments:\n  {P.device_action}:\n    mesh: auto\n"
                "tiers:\n- plugins:\n  - name: gang\n"
            )
            assert conf.action_arguments == {P.device_action: {"mesh": "auto"}}
            return conf.action_arguments[P.device_action]

        both(case)

    def test_unknown_action_raises(self):
        def case(P):
            with pytest.raises(ValueError):
                P.conf.load_scheduler_conf('actions: "no-such-action"')
            return True

        both(case)

    def test_full_pipeline_order(self):
        def case(P):
            actions_list, _, _ = P.conf.load_scheduler_conf('actions: "enqueue, reclaim, allocate, backfill, preempt"')
            names = [a.name for a in actions_list]
            assert names == ["enqueue", "reclaim", "allocate", "backfill", "preempt"]
            return names

        both(case)


class TestRound1Fixes:
    def test_build_resource_list_kwarg_translation(self):
        def case(P):
            rl = P.testing.build_resource_list(cpu=1, nvidia__com__gpu=2)
            assert rl == {"cpu": 1.0, "nvidia.com/gpu": 2.0}
            rl2 = P.testing.build_resource_list(google__com__tpu=8)
            assert rl2 == {"google.com/tpu": 8.0}
            return rl, rl2

        both(case)

    def test_from_resource_list_ignores_non_scalar_names(self):
        def case(P):
            r = P.resource.Resource.from_resource_list({"cpu": 1, "ephemeral-storage": 10_000_000, "nvidia.com/gpu": 2})
            assert r.scalars == {"nvidia.com/gpu": 2000.0}
            return r.milli_cpu, r.memory, r.scalars

        both(case)

    def test_sub_scalar_onto_scalar_free_receiver_raises(self):
        def case(P):
            Resource = P.resource.Resource
            r = Resource(milli_cpu=1000, memory=1000)
            with pytest.raises(ValueError):
                r.sub(Resource(milli_cpu=500, memory=500, scalars={"g": 5}))
            assert r.scalars == {}
            return r.milli_cpu, r.memory

        both(case)

    def test_min_resource_drops_scalars_when_either_side_nil(self):
        def case(P):
            Resource = P.resource.Resource
            left = Resource(milli_cpu=100, memory=100, scalars={"g": 5})
            out = P.helpers.min_resource(left, Resource(milli_cpu=200, memory=50))
            assert out.milli_cpu == 100 and out.memory == 50
            assert out.scalars == {}
            both_sides = P.helpers.min_resource(left, Resource(milli_cpu=0, memory=0, scalars={"g": 2}))
            assert both_sides.scalars == {"g": 2}
            return (out.milli_cpu, out.memory), both_sides.scalars

        both(case)

    def test_validate_status_update_rejects_terminal_reentry(self):
        def case(P):
            TaskStatus, validate = P.types.TaskStatus, P.types.validate_status_update
            with pytest.raises(ValueError):
                validate(TaskStatus.SUCCEEDED, TaskStatus.ALLOCATED)
            validate(TaskStatus.PENDING, TaskStatus.ALLOCATED)
            validate(TaskStatus.ALLOCATED, TaskStatus.BINDING)
            validate(TaskStatus.RUNNING, TaskStatus.RELEASING)
            return True

        both(case)

    def test_fake_binder_signals_once_per_bind(self):
        def case(P):
            binder = P.testing.FakeBinder()
            binder.bind(P.testing.build_pod(name="a"), "n1")
            binder.bind(P.testing.build_pod(name="b"), "n2")
            got = [binder.channel.get_nowait(), binder.channel.get_nowait()]
            assert got == ["default/a", "default/b"]
            assert binder.channel.empty()
            return got, binder.binds

        both(case)
