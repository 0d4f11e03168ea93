"""Command line of the PyTorch port.

    python -m wis_tpu_torch.cli run [--port 19000] [--no-warmup] [--tls-cert C --tls-key K]
                                    [--device cuda]
    python -m wis_tpu_torch.cli run-tts [--port 19010] [--device cuda]
    python -m wis_tpu_torch.cli convert-model --selftest <size|xtts> [--no-forward]
    python -m wis_tpu_torch.cli convert-model <src> --size <size>
    python -m wis_tpu_torch.cli bench [--device cuda] [--fixtures DIR]
    python -m wis_tpu_torch.cli check [--device cuda]
    python -m wis_tpu_torch.cli check-edge

``run`` and ``run-tts`` are ``wisctl run`` and ``wisctl run-tts`` on the
port's apps (``server/app.py``, ``server/tts_app.py``): the ASR server,
TLS-direct when a certificate and key are given, with a keep-alive of an
hour, and the TTS server. They need aiohttp; their ``--help`` does not.
``python -m wis_tpu_torch.server.app [port]`` and ``python -m
wis_tpu_torch.server.tts_app [port]`` (the apps' ``main``) run ``run`` and
``run-tts`` on that port.

``convert-model`` is the port's counterpart of ``wisctl convert-model``:
``--selftest <size>`` converts a synthetic full-dims HF Whisper
checkpoint and runs one encoder pass plus the cross-KV projection,
``--selftest xtts`` a synthetic XTTS v2 ``model.pth`` (GPT, HiFi-GAN and
conditioning encoder) and runs one vocoder call, one GPT prefill and one
conditioning pass (``utils/selftest.py``), printing the report as one JSON
line; with a
checkpoint directory ``<src>`` it converts the safetensors there and runs
the encoder once. Both print what ``wisctl`` prints. Per the port's device
policy both run on the card unless ``--device cpu`` asks for the CPU
(``wisctl`` runs its self-test on the CPU).

``bench`` runs the port's benchmark (``wis_tpu_torch/bench.py``, the rows
of ``bench.py``). ``check`` is ``wisctl check`` for the port: torch and
CUDA versions, each visible card's name and power limit, whether the
kernel library is built and the wisaudio library loads, the default model
and dtype and the device-memory budget; with ``--device cuda`` (the
default) it raises without a card. ``check-edge`` is ``wisctl
check-edge``: the structural nginx and compose checks of the checked-in
edge configs (``utils/edgecheck.py``), the same report and exit code.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional


def cmd_convert_model(args) -> int:
    if args.selftest == "xtts":
        from wis_tpu_torch.utils.selftest import xtts_selftest

        report = xtts_selftest(forward=not args.no_forward, device=args.device)
        print(json.dumps({"selftest": "ok", **report}))
        return 0
    if args.selftest:
        from wis_tpu_torch.utils.selftest import whisper_selftest

        report = whisper_selftest(args.selftest, forward=not args.no_forward,
                                  device=args.device)
        print(json.dumps({"selftest": "ok", **report}))
        return 0
    if not args.src or not args.size:
        print("convert-model without --selftest needs <src> and a "
              "whisper size", file=sys.stderr)
        return 1

    import torch

    from wis_tpu_torch.device import resolve_device
    from wis_tpu_torch.models.whisper.config import WHISPER_CONFIGS, resolve_model_name
    from wis_tpu_torch.models.whisper.model import encode
    from wis_tpu_torch.models.whisper.weights import _hf_tensors, params_from_hf

    device = resolve_device(args.device)
    cfg = WHISPER_CONFIGS[resolve_model_name(args.size)]
    tensors = _hf_tensors(args.src)
    if not tensors:
        print(f"no safetensors found in {args.src}", file=sys.stderr)
        return 1
    params = params_from_hf(tensors, cfg, torch.bfloat16, device)
    with torch.inference_mode():
        out = encode(params, torch.zeros((1, cfg.n_mels, 3000), device=device), cfg)
        assert bool(torch.isfinite(out).all())
    print(f"converted {args.size}: encoder OK, output {tuple(out.shape)}")
    return 0


def _aiohttp_web():
    try:
        from aiohttp import web
    except ImportError as e:
        raise ImportError(f"serving needs aiohttp, which is not installed ({e})") from e
    return web


def cmd_run(args) -> int:
    import ssl

    from wis_tpu_torch.server.app import create_app
    from wis_tpu_torch.utils.logging import configure_logging

    web = _aiohttp_web()
    configure_logging()
    ssl_ctx = None
    if args.tls_cert and args.tls_key:
        ssl_ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ssl_ctx.load_cert_chain(args.tls_cert, args.tls_key)
    web.run_app(
        create_app(warmup=not args.no_warmup, device=args.device),
        port=args.port,
        ssl_context=ssl_ctx,
        keepalive_timeout=3600,
    )
    return 0


def cmd_run_tts(args) -> int:
    from wis_tpu_torch.server.tts_app import create_tts_app
    from wis_tpu_torch.utils.logging import configure_logging

    web = _aiohttp_web()
    configure_logging()
    web.run_app(create_tts_app(device=args.device), port=args.port)
    return 0


def cmd_bench(args) -> int:
    from wis_tpu_torch.bench import main as bench_main

    argv = ["--device", args.device]
    if args.fixtures:
        argv += ["--fixtures", args.fixtures]
    return bench_main(argv)


def cmd_check(args) -> int:
    import torch

    from wis_tpu_torch.audio import codecs
    from wis_tpu_torch.device import card_info, resolve_device
    from wis_tpu_torch.ops import _build
    from wis_tpu_torch.settings import get_api_settings

    device = resolve_device(args.device)
    print(f"torch {torch.__version__}; CUDA {torch.version.cuda}; device {device}")
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    print(f"CUDA devices: {n}")
    for i in range(n):
        info = card_info(i)
        print(f"  cuda:{i}: {info['name']}, power limit {info['power_limit']}")
    lib = _build.library_path()
    print(f"kernel library: {'built' if lib.exists() else 'NOT BUILT'} ({lib})")
    print(f"native codecs: {'OK' if codecs.native_available() else 'MISSING'}")
    s = get_api_settings()
    print(f"default model: {s.whisper_model_default}; dtype {s.dtype}")
    print(f"HBM budget: {s.hbm_budget_bytes / 2**30:.1f} GiB")
    return 0


def cmd_check_edge(args) -> int:
    """The structural ``nginx -t`` and ``docker compose config`` checks of
    the checked-in edge configs."""
    import glob

    from wis_tpu_torch.utils.edgecheck import (
        check_compose,
        check_nginx_conf,
        parse,
        render_auth_template,
        validate,
    )

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    failures = 0

    def report(label, problems):
        nonlocal failures
        if problems:
            failures += 1
            print(f"FAIL {label}")
            for prob in problems:
                print(f"  {prob}")
        else:
            print(f"ok   {label}")

    report("nginx/nginx.conf", check_nginx_conf(os.path.join(root, "nginx/nginx.conf")))
    with open(os.path.join(root, "nginx/auth.conf.template")) as f:
        report(
            "nginx/auth.conf.template",
            validate(parse(render_auth_template(f.read(), API_KEY="k")), context="http"),
        )
    with open(os.path.join(root, "nginx/auth-basic.conf.template")) as f:
        report(
            "nginx/auth-basic.conf.template",
            validate(parse(render_auth_template(f.read(), AUTH_BASIC="off")), context="server"),
        )
    for comp in sorted(glob.glob(os.path.join(root, "docker-compose*.yml"))):
        report(os.path.basename(comp), check_compose(comp, root))
    return 1 if failures else 0


def _size(name: str) -> str:
    from wis_tpu_torch.models.whisper.config import resolve_model_name

    try:
        resolve_model_name(name)
    except KeyError:
        raise argparse.ArgumentTypeError(f"unknown whisper size {name!r}") from None
    return name


def _selftest_size(name: str) -> str:
    return name if name == "xtts" else _size(name)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="python -m wis_tpu_torch.cli")
    sub = parser.add_subparsers(dest="cmd", required=True)
    device_help = "cuda (the default), cuda:N or cpu"
    r = sub.add_parser("run", help="start the ASR server (needs aiohttp)")
    r.add_argument("--port", type=int, default=19000)
    r.add_argument("--no-warmup", action="store_true")
    r.add_argument("--tls-cert", help="serve TLS directly (cert path)")
    r.add_argument("--tls-key", help="serve TLS directly (key path)")
    r.add_argument("--device", default="cuda", help=device_help)
    r.set_defaults(fn=cmd_run)
    t = sub.add_parser("run-tts", help="start the TTS server (needs aiohttp)")
    t.add_argument("--port", type=int, default=19010)
    t.add_argument("--device", default="cuda", help=device_help)
    t.set_defaults(fn=cmd_run_tts)
    c = sub.add_parser(
        "convert-model",
        help="validate a local HF checkpoint, or --selftest the converter "
        "against a synthetic checkpoint at the size's REAL dims",
    )
    c.add_argument("src", nargs="?", default=None,
                   help="HF checkpoint dir (omit with --selftest)")
    c.add_argument("--size", type=_size, help="whisper size of <src>")
    c.add_argument("--selftest", metavar="SIZE", type=_selftest_size,
                   help="synthesize a full-dims checkpoint of this whisper size "
                   "(or of XTTS v2: xtts) and convert it")
    c.add_argument("--no-forward", action="store_true",
                   help="with --selftest: skip the forward passes")
    c.add_argument("--device", default="cuda", help=device_help)
    c.set_defaults(fn=cmd_convert_model)
    b = sub.add_parser("bench", help="run the benchmark (bench.py's rows)")
    b.add_argument("--device", default="cuda", help=device_help)
    b.add_argument("--fixtures", default=None,
                   help="directory of the reference client's clips; without it, seeded noise")
    b.set_defaults(fn=cmd_bench)
    ck = sub.add_parser("check", help="environment / device diagnostic")
    ck.add_argument("--device", default="cuda", help=device_help)
    ck.set_defaults(fn=cmd_check)
    ce = sub.add_parser("check-edge", help="validate nginx + compose configs")
    ce.set_defaults(fn=cmd_check_edge)
    return parser


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
