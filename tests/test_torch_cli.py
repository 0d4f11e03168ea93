"""The port's command line (``wis_tpu_torch/cli.py``) beside ``wisctl``:
``check-edge`` prints the same report with the same exit code, on the
repo's configs and on a broken one; the parser has ``bench``, ``check``
and ``check-edge``; ``check --device cpu`` prints its fields and ``check``
raises without a card; and no module of the port imports ``wis_tpu`` or
JAX (a fresh interpreter that refuses them imports every module and runs
``check`` and ``check-edge``); ``python -m wis_tpu_torch.server.app
[port]`` and ``...tts_app [port]`` serve through ``run`` / ``run-tts``
with ``wis_tpu``'s default ports and, without a card, exit with the
device error instead of serving on the CPU.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import wisctl  # noqa: E402
from wis_tpu_torch import cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(main, argv, capsys):
    rc = main(argv)
    return rc, capsys.readouterr().out


def test_check_edge_equals_wisctl(capsys):
    got = _run(cli.main, ["check-edge"], capsys)
    want = _run(wisctl.main, ["check-edge"], capsys)
    assert got == want
    assert got[0] == 0 and got[1].count("ok   ") == 5


def test_check_edge_failure_equals_wisctl(capsys, monkeypatch):
    """A broken nginx.conf: FAIL with its problems, exit 1, in both."""
    from wis_tpu.utils import edgecheck as jax_edge
    from wis_tpu_torch.utils import edgecheck as edge

    for mod in (edge, jax_edge):
        monkeypatch.setattr(mod, "check_nginx_conf",
                            lambda path, mod=mod: mod.validate(mod.parse("http { proxy_passs x; }")))
    got = _run(cli.main, ["check-edge"], capsys)
    want = _run(wisctl.main, ["check-edge"], capsys)
    assert got == want
    assert got[0] == 1
    assert got[1].startswith("FAIL nginx/nginx.conf\n  line 1: unknown directive 'proxy_passs'\n")


def test_parser_has_the_new_subcommands():
    sub = next(a for a in cli.build_parser()._actions if a.dest == "cmd")
    assert {"bench", "check", "check-edge"} <= set(sub.choices)
    assert {"run", "run-tts", "convert-model"} <= set(sub.choices)
    args = cli.build_parser().parse_args(["check"])
    assert (args.device, args.fn) == ("cuda", cli.cmd_check)
    args = cli.build_parser().parse_args(["bench", "--device", "cpu"])
    assert (args.device, args.fixtures, args.fn) == ("cpu", None, cli.cmd_bench)
    assert cli.build_parser().parse_args(["check-edge"]).fn is cli.cmd_check_edge


def test_check_on_the_cpu(capsys):
    rc, out = _run(cli.main, ["check", "--device", "cpu"], capsys)
    lines = out.strip().splitlines()
    assert rc == 0
    assert lines[0] == f"torch {torch.__version__}; CUDA {torch.version.cuda}; device cpu"
    assert lines[1].startswith("CUDA devices: ")
    assert any(line.startswith("kernel library: ") and "libwis_kernels.so" in line
               for line in lines)
    assert any(line.startswith("native codecs: ") for line in lines)
    from wis_tpu_torch.settings import get_api_settings

    s = get_api_settings()
    assert f"default model: {s.whisper_model_default}; dtype {s.dtype}" in lines
    assert lines[-1] == f"HBM budget: {s.hbm_budget_bytes / 2**30:.1f} GiB"


@pytest.mark.skipif(torch.cuda.is_available(), reason="asserts the refusal without a card")
def test_check_without_a_card_raises():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["check"])


GUARD = r'''
import importlib, io, json, pkgutil, sys, contextlib

REFUSED = ("jax", "jaxlib", "wis_tpu", "regex", "transformers")
refused = []

class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in REFUSED:
            refused.append(name)
            raise ImportError(f"{name} is refused here")

sys.meta_path.insert(0, Refuse())

import wis_tpu_torch
from wis_tpu_torch import cli

skipped = {}
modules = []
for info in pkgutil.walk_packages(wis_tpu_torch.__path__, "wis_tpu_torch."):
    try:
        importlib.import_module(info.name)
        modules.append(info.name)
    except ImportError as e:  # an optional package this host lacks (aiortc)
        skipped[info.name] = str(e)
out = io.StringIO()
with contextlib.redirect_stdout(out):
    rc = [cli.main(["check-edge"]), cli.main(["check", "--device", "cpu"])]
print(json.dumps({"refused": refused, "skipped": skipped, "modules": modules, "rc": rc,
                  "version": wis_tpu_torch.__version__,
                  "loaded": sorted({m.split(".")[0] for m in sys.modules} & set(REFUSED))}))
'''


def test_no_port_module_imports_wis_tpu_or_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", GUARD], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-4000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["refused"] == [] and out["loaded"] == []
    assert all("refused" not in why for why in out["skipped"].values()), out["skipped"]
    assert set(out["skipped"]) <= {"wis_tpu_torch.server.rtc"}, out["skipped"]
    for name in ("wis_tpu_torch.bench", "wis_tpu_torch.entry", "wis_tpu_torch.version",
                 "wis_tpu_torch.utils.edgecheck", "wis_tpu_torch.cli"):
        assert name in out["modules"]
    assert out["rc"] == [0, 0]
    from wis_tpu.version import __version__

    assert out["version"] == __version__


MAINS = [("wis_tpu_torch.server.app", "create_app", 19000,
          dict(warmup=True, device="cuda"), dict(ssl_context=None, keepalive_timeout=3600)),
         ("wis_tpu_torch.server.tts_app", "create_tts_app", 19010, dict(device="cuda"), {})]


@pytest.mark.parametrize("module,factory,default,app_kw,run_kw", MAINS)
@pytest.mark.parametrize("argv", [[], ["8123"]])
def test_server_main_parses_the_port(monkeypatch, module, factory, default, app_kw, run_kw,
                                     argv):
    """``main()`` reads ``[port]`` from argv as ``wis_tpu``'s mains do, logs
    as they do, and serves what the CLI's ``run`` / ``run-tts`` serve."""
    import importlib

    from aiohttp import web

    from wis_tpu_torch.utils import logging as port_logging

    mod = importlib.import_module(module)
    calls = []
    monkeypatch.setattr(mod, factory, lambda **kw: ("app", kw))
    monkeypatch.setattr(web, "run_app", lambda app, **kw: calls.append((app, kw)))
    monkeypatch.setattr(port_logging, "configure_logging", lambda: calls.append("logging"))
    monkeypatch.setattr(sys, "argv", [module] + argv)
    mod.main()
    port = int(argv[0]) if argv else default
    assert calls == ["logging", (("app", app_kw), dict(port=port, **run_kw))]


@pytest.mark.parametrize("module", [m[0] for m in MAINS])
def test_server_main_without_a_card_refuses(module):
    if torch.cuda.is_available():
        pytest.skip("asserts the refusal without a card")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-m", module, "0"], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert "RuntimeError: device 'cuda' requested but no CUDA device is available" in res.stderr
    assert "Running on" not in res.stdout + res.stderr
