"""Edge-config validation: structural nginx.conf syntax checking plus
docker-compose sanity, without an nginx binary — a copy of
``wis_tpu/utils/edgecheck.py`` with its names and behaviour, carried so
that ``python -m wis_tpu_torch.cli check-edge`` imports nothing of the JAX
package (tests/test_torch_edgecheck.py holds the two equal).

The reference's nginx actually fronts its containers at every boot
(reference docker-compose.yml:1-64, nginx/nginx.conf:84-114), so a typo'd
directive fails fast there. This repo's edge configs are artifacts — CI
must catch a broken directive before it ships (VERDICT round 3, Missing
#4). This module implements the checks `nginx -t` would do structurally:

- full tokenizer/parser for the nginx config grammar (comments, quoted
  strings, `directive args... ;`, `block { ... }`)
- directive-name allowlist (catches `proxy_passs`-style typos)
- context rules (a `location` outside `server` is a boot failure)
- semantic cross-checks: every proxy_pass upstream is declared, every
  proxy_cache zone has a keys_zone, ssl servers declare cert+key
- auth template rendering (the exact substitution `wisctl gen-auth`
  performs) followed by a parse of the rendered snippet

Used by `python -m wis_tpu_torch.cli check-edge`.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import List, Optional


class NginxConfigError(ValueError):
    pass


@dataclass
class Directive:
    name: str
    args: List[str]
    block: Optional[List["Directive"]] = None
    line: int = 0

    def walk(self):
        yield self
        for child in self.block or ():
            yield from child.walk()


# Every directive the repo's edge configs may legally use (nginx core +
# http + ssl + proxy + map/upstream modules). An unknown name is exactly
# what `nginx -t` rejects with "unknown directive".
KNOWN_DIRECTIVES = {
    # core / events
    "worker_processes", "worker_connections", "events", "include",
    "pid", "user", "error_log", "daemon",
    # http core
    "http", "server", "location", "listen", "server_name", "root",
    "index", "default_type", "sendfile", "tcp_nopush", "tcp_nodelay",
    "keepalive_timeout", "client_max_body_size", "access_log",
    "log_format", "add_header", "types", "http2", "return", "rewrite",
    "error_page", "try_files", "gzip", "gzip_types", "resolver",
    "client_body_buffer_size", "if",
    # ssl
    "ssl_certificate", "ssl_certificate_key", "ssl_protocols",
    "ssl_ciphers", "ssl_prefer_server_ciphers", "ssl_ecdh_curve",
    "ssl_session_cache", "ssl_session_timeout",
    # proxy
    "proxy_pass", "proxy_http_version", "proxy_set_header",
    "proxy_buffering", "proxy_request_buffering", "proxy_read_timeout",
    "proxy_send_timeout", "proxy_connect_timeout", "proxy_cache",
    "proxy_cache_path", "proxy_cache_key", "proxy_cache_valid",
    "proxy_cache_lock", "proxy_cache_use_stale", "proxy_redirect",
    "proxy_ssl_verify",
    # upstream
    "upstream", "server", "keepalive", "least_conn", "ip_hash",
    # map / auth
    "map", "auth_basic", "auth_basic_user_file", "auth_request",
}

#: contexts each block directive may appear in ("" = top level)
BLOCK_CONTEXTS = {
    "events": {""},
    "http": {""},
    "server": {"http", "upstream"},  # upstream has its own `server` (flat)
    "location": {"server", "location"},
    "upstream": {"http"},
    "map": {"http"},
    "types": {"http", "server", "location"},
    "if": {"server", "location"},
}

#: directives that open a block (everything else must end with `;`)
BLOCK_DIRECTIVES = set(BLOCK_CONTEXTS)

_TOKEN_RE = re.compile(
    r"""
    (?P<comment>\#[^\n]*)
  | (?P<dquote>"(?:[^"\\]|\\.)*")
  | (?P<squote>'(?:[^'\\]|\\.)*')
  | (?P<brace>[{}])
  | (?P<semi>;)
  | (?P<word>[^\s{};#'"]+)
  | (?P<ws>\s+)
    """,
    re.VERBOSE,
)


def tokenize(text: str):
    """Yield (kind, value, line) for the nginx config grammar."""
    pos = 0
    line = 1
    while pos < len(text):
        m = _TOKEN_RE.match(text, pos)
        if not m:
            raise NginxConfigError(f"line {line}: unparseable input at {text[pos:pos+20]!r}")
        kind = m.lastgroup
        val = m.group()
        if kind not in ("ws", "comment"):
            yield kind, val, line
        line += val.count("\n")
        pos = m.end()


def parse(text: str) -> List[Directive]:
    """Parse an nginx config (or snippet) into a directive tree.
    Raises NginxConfigError on grammar violations (the errors `nginx -t`
    reports as "unexpected end of file", "unexpected {", …)."""
    tokens = list(tokenize(text))
    i = 0

    def parse_block(depth: int, opened_line: int) -> List[Directive]:
        nonlocal i
        out: List[Directive] = []
        words: List[str] = []
        word_line = 0
        while i < len(tokens):
            kind, val, line = tokens[i]
            i += 1
            if kind in ("word", "dquote", "squote"):
                if not words:
                    word_line = line
                words.append(val.strip("\"'") if kind != "word" else val)
            elif kind == "semi":
                if not words:
                    raise NginxConfigError(f"line {line}: empty directive (stray ';')")
                out.append(Directive(words[0], words[1:], None, word_line))
                words = []
            elif kind == "brace" and val == "{":
                if not words:
                    raise NginxConfigError(f"line {line}: '{{' without a directive name")
                block = parse_block(depth + 1, line)
                out.append(Directive(words[0], words[1:], block, word_line))
                words = []
            elif kind == "brace" and val == "}":
                if words:
                    raise NginxConfigError(
                        f"line {line}: directive {words[0]!r} missing ';' before '}}'"
                    )
                if depth == 0:
                    raise NginxConfigError(f"line {line}: unexpected '}}'")
                return out
        if depth != 0:
            raise NginxConfigError(
                f"unexpected end of file: block opened at line {opened_line} never closed"
            )
        if words:
            raise NginxConfigError(
                f"line {word_line}: directive {words[0]!r} missing ';' at end of file"
            )
        return out

    return parse_block(0, 0)


def validate(
    tree: List[Directive],
    *,
    context: str = "",
    known: Optional[set] = None,
) -> List[str]:
    """Return a list of problems (empty = valid). `context` names the
    enclosing block for snippets (auth templates validate with
    context='http')."""
    known = known or KNOWN_DIRECTIVES
    problems: List[str] = []
    upstreams: set = set()
    cache_zones: set = set()
    used_zones: List[tuple] = []
    proxy_targets: List[tuple] = []

    def visit(d: Directive, ctx: str):
        if ctx in ("map", "types"):
            # map/types block bodies are key→value entries, not directives
            if d.block is not None:
                problems.append(
                    f"line {d.line}: nested block inside {ctx!r} entry"
                )
            return
        if d.name not in known:
            problems.append(f"line {d.line}: unknown directive {d.name!r}")
        if d.block is not None:
            allowed = BLOCK_CONTEXTS.get(d.name)
            if allowed is not None and ctx not in allowed:
                where = "top-level" if not ctx else repr(ctx)
                problems.append(
                    f"line {d.line}: {d.name!r} not allowed in {where} context"
                )
            if d.name == "upstream":
                if not d.args:
                    problems.append(f"line {d.line}: upstream without a name")
                else:
                    upstreams.add(d.args[0])
            for child in d.block:
                visit(child, d.name)
        else:
            if d.name in BLOCK_DIRECTIVES and d.name not in ("server", "if", "types"):
                problems.append(f"line {d.line}: {d.name!r} requires a {{ block }}")
            if d.name == "proxy_cache_path":
                for a in d.args:
                    if a.startswith("keys_zone="):
                        cache_zones.add(a.split("=", 1)[1].split(":", 1)[0])
            elif d.name == "proxy_cache" and d.args and d.args[0] != "off":
                used_zones.append((d.line, d.args[0]))
            elif d.name == "proxy_pass" and d.args:
                proxy_targets.append((d.line, d.args[0]))
            elif d.name == "listen" and not d.args:
                problems.append(f"line {d.line}: listen without an address")

    for d in tree:
        visit(d, context)

    for line, zone in used_zones:
        if zone not in cache_zones and context == "":
            problems.append(
                f"line {line}: proxy_cache zone {zone!r} has no proxy_cache_path keys_zone"
            )
    for line, target in proxy_targets:
        m = re.match(r"https?://([^/$:]+)", target)
        if m and "." not in m.group(1) and "$" not in m.group(1):
            if m.group(1) not in upstreams and context == "":
                problems.append(
                    f"line {line}: proxy_pass upstream {m.group(1)!r} is not declared"
                )

    # ssl servers must declare cert + key (nginx refuses to boot otherwise)
    def ssl_check(d: Directive):
        if d.name == "server" and d.block is not None:
            has_ssl_listen = any(
                c.name == "listen" and "ssl" in c.args for c in d.block
            )
            if has_ssl_listen:
                names = {c.name for c in d.block}
                for req in ("ssl_certificate", "ssl_certificate_key"):
                    if req not in names:
                        problems.append(
                            f"line {d.line}: ssl server missing {req!r}"
                        )
        for c in d.block or ():
            ssl_check(c)

    for d in tree:
        ssl_check(d)
    return problems


def render_auth_template(template_text: str, **subs: str) -> str:
    """The exact substitution `wisctl gen-auth` performs: %%NAME%% →
    value. Unreplaced placeholders are an error (a rendered config with
    a literal %%API_KEY%% would silently reject every request)."""
    out = template_text
    for name, value in subs.items():
        out = out.replace(f"%%{name}%%", value)
    leftover = re.findall(r"%%[A-Z_]+%%", out)
    if leftover:
        raise NginxConfigError(f"unrendered placeholders: {leftover}")
    return out


def check_nginx_conf(path: str) -> List[str]:
    with open(path) as f:
        return validate(parse(f.read()))


def check_compose(path: str, repo_root: str) -> List[str]:
    """Structural checks `docker compose config` would do: YAML parses,
    services are well-formed, bind-mount sources exist in the repo,
    depends_on/volumes references resolve."""
    import os

    import yaml

    problems: List[str] = []
    with open(path) as f:
        doc = yaml.safe_load(f)
    services = doc.get("services")
    if not isinstance(services, dict) or not services:
        return [f"{path}: no services defined"]
    named_volumes = set((doc.get("volumes") or {}).keys())
    for name, svc in services.items():
        if not isinstance(svc, dict):
            problems.append(f"service {name}: not a mapping")
            continue
        if "image" not in svc and "build" not in svc:
            problems.append(f"service {name}: neither image nor build")
        for dep in svc.get("depends_on", []):
            if dep not in services:
                problems.append(f"service {name}: depends_on unknown service {dep!r}")
        for vol in svc.get("volumes", []):
            src = str(vol).split(":", 1)[0]
            if src.startswith("./") or src.startswith("../"):
                # bind mount: tolerate runtime-generated paths (certs,
                # gen-auth output, downloaded models) but require
                # checked-in config sources to exist
                full = os.path.join(repo_root, src)
                if (
                    not os.path.exists(full)
                    and not os.path.exists(full + ".template")
                    and (src.endswith(".conf") or src.endswith(".yml"))
                ):
                    problems.append(
                        f"service {name}: bind mount source {src} missing"
                    )
            elif not src.startswith("/") and src not in named_volumes:
                problems.append(
                    f"service {name}: named volume {src!r} not declared"
                )
        for port in svc.get("ports", []):
            if not re.match(r"^\d+(:\d+)?(/(tcp|udp))?$", str(port)):
                problems.append(f"service {name}: malformed port {port!r}")
    return problems
