"""Typed option registry + HM-style config-file / GNU CLI parser.

Behavior parity with the reference's df::program_options_lite
(source/Lib/TAppCommon/program_options_lite.{h,cpp}): a registry of typed
options with long and optional short names and defaults; `.cfg` files of
`Name : value  # comment` lines (scanLine semantics: first token up to
whitespace/':', value runs to a '#' comment or EOL); GNU `--Name=value`
and short `-x value` command-line options; `-c file` pulls in config
files (multiple allowed, later wins); booleans accept 0/1/true/false.
Unknown config-file keys warn instead of failing (HM behavior), unknown
command-line options raise.
"""

from __future__ import annotations

import sys


class Opt:
    __slots__ = ("name", "short", "default", "typ", "desc", "multi")

    def __init__(self, name, default, desc="", short=None, multi=False):
        self.name = name
        self.short = short
        self.default = default
        if multi and isinstance(default, list):
            self.typ = type(default[0]) if default else str
        else:
            self.typ = type(default) if default is not None else str
        self.desc = desc
        self.multi = multi            # list-valued (space-separated)


class Options:
    def __init__(self):
        self._by_name: dict[str, Opt] = {}
        self._by_short: dict[str, Opt] = {}
        self.values: dict[str, object] = {}
        self.warnings: list[str] = []

    def add(self, name, default, desc="", short=None, multi=False):
        o = Opt(name, default, desc, short, multi)
        self._by_name[name] = o
        if short:
            self._by_short[short] = o
        self.values[name] = default
        return self

    def __getitem__(self, name):
        return self.values[name]

    def _store(self, opt: Opt, raw: str):
        self.values[opt.name] = self._convert(opt, raw)

    @staticmethod
    def _convert(opt: Opt, raw: str):
        raw = raw.strip()
        if opt.multi:
            return [Options._scalar(opt.typ, t) for t in raw.split()]
        return Options._scalar(opt.typ, raw)

    @staticmethod
    def _scalar(typ, raw):
        if typ is bool:
            return raw.lower() in ("1", "true", "yes", "on")
        if typ is int:
            return int(raw, 0)
        if typ is float:
            return float(raw)
        return raw

    # ---- config files (parseConfigFile / scanLine) -------------------

    def parse_config_file(self, path: str):
        with open(path) as f:
            for lineno, line in enumerate(f, 1):
                self._scan_line(line, f"{path}:{lineno}")

    def _scan_line(self, line: str, where: str):
        # strip comment (outside of nothing fancy; HM has no quoting)
        hash_pos = line.find("#")
        if hash_pos >= 0:
            line = line[:hash_pos]
        line = line.strip()
        if not line:
            return
        if ":" in line:
            name, _, value = line.partition(":")
        else:
            parts = line.split(None, 1)
            name, value = parts[0], parts[1] if len(parts) > 1 else ""
        name = name.strip()
        value = value.strip()
        opt = self._by_name.get(name)
        if opt is None:
            self.warnings.append(f"Unknown option `{name}' at {where}")
            return
        self._store(opt, value)

    # ---- command line (parseGNU / doHelp) -----------------------------

    def parse_cli(self, argv: list[str]) -> list[str]:
        """Parse args; `-c file` includes config files first-come; returns
        leftover positional arguments."""
        rest = []
        i = 0
        while i < len(argv):
            a = argv[i]
            if a == "-c":
                i += 1
                self.parse_config_file(argv[i])
            elif a.startswith("--"):
                body = a[2:]
                if "=" in body:
                    name, _, value = body.partition("=")
                    self._store_cli(name, value)
                else:
                    opt = self._by_name.get(body)
                    if opt is None:
                        raise ValueError(f"Unknown option `{a}'")
                    if opt.typ is bool:
                        self.values[body] = True
                    else:
                        i += 1
                        self._store(opt, argv[i])
            elif a.startswith("-") and len(a) > 1 and not a[1].isdigit():
                opt = self._by_short.get(a[1:])
                if opt is None:
                    raise ValueError(f"Unknown option `{a}'")
                i += 1
                self._store(opt, argv[i])
            else:
                rest.append(a)
            i += 1
        return rest

    def _store_cli(self, name, value):
        opt = self._by_name.get(name) or self._by_short.get(name)
        if opt is None:
            raise ValueError(f"Unknown option `--{name}'")
        self._store(opt, value)

    def do_help(self, out=sys.stdout):
        for o in self._by_name.values():
            short = f"-{o.short}, " if o.short else ""
            out.write(f"  {short}--{o.name:<34} {o.desc} "
                      f"[{o.default}]\n")
