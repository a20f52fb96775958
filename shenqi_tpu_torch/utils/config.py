"""Typed parameter registry + Gadget-format parameter file parser.

Equivalent in behavior to the reference config system
(libgadget/utils/paramset.h:17-33): parameters are declared with a type
(int/double/string/enum), a REQUIRED/OPTIONAL flag, a help string and a
default; files are `key = value  # comment` lines; unknown keys and missing
required keys are errors.  This lets the same parameter files that drive the
reference drive this framework.

A copy of shenqi_tpu/utils/config.py (no JAX in it) so that the PyTorch port
imports nothing of the JAX package; tests/test_torch_genic_io.py pins it.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional


class ParamError(ValueError):
    pass


REQUIRED = 1
OPTIONAL = 0


@dataclass
class _ParamDecl:
    name: str
    ptype: str                    # 'int' | 'double' | 'string' | 'enum'
    required: int
    default: Any
    help: str
    enum_table: Optional[Dict[str, int]] = None
    action: Optional[Callable[[str, Any], None]] = None


@dataclass
class ParameterSet:
    """Declare-then-parse typed configuration.

    Usage:
        ps = ParameterSet()
        ps.declare_double("Omega0", REQUIRED, 0, "Total matter density")
        ps.parse_file("paramfile.gadget")
        omega = ps.get_double("Omega0")
    """

    decls: Dict[str, _ParamDecl] = field(default_factory=dict)
    values: Dict[str, Any] = field(default_factory=dict)
    _set_from_file: set = field(default_factory=set)

    # ---- declaration ----
    def _declare(self, name, ptype, required, default, help, enum_table=None):
        if name in self.decls:
            raise ParamError(f"parameter {name} declared twice")
        self.decls[name] = _ParamDecl(name, ptype, required, default, help,
                                      enum_table)
        if required == OPTIONAL and default is not None:
            self.values[name] = default

    def declare_int(self, name, required=OPTIONAL, default=0, help=""):
        self._declare(name, "int", required, default, help)

    def declare_double(self, name, required=OPTIONAL, default=0.0, help=""):
        self._declare(name, "double", required,
                      None if default is None else float(default), help)

    def declare_string(self, name, required=OPTIONAL, default="", help=""):
        self._declare(name, "string", required, default, help)

    def declare_enum(self, name, enum_table: Dict[str, int],
                     required=OPTIONAL, default="", help=""):
        self._declare(name, "enum", required,
                      enum_table.get(default, None) if default else None,
                      help, enum_table)

    # ---- parsing ----
    def _convert(self, decl: _ParamDecl, raw: str):
        raw = raw.strip()
        if decl.ptype == "int":
            try:
                return int(raw)
            except ValueError:
                # Gadget accepts e.g. "1.0" for ints in places
                return int(float(raw))
        if decl.ptype == "double":
            return float(raw)
        if decl.ptype == "string":
            return raw.strip('"')
        if decl.ptype == "enum":
            # multi-valued enums OR together, split on , | & or
            # whitespace (reference paramset.c param_format_enum)
            import re
            keys = [k for k in re.split(r"[,|&\s]+", raw.strip('"'))
                    if k]
            value = 0
            for key in keys:
                if key not in decl.enum_table:
                    raise ParamError(
                        f"{decl.name}: unknown enum value '{key}' "
                        f"(allowed: {sorted(decl.enum_table)})")
                value |= decl.enum_table[key]
            return value
        raise ParamError(f"unknown ptype {decl.ptype}")

    def set_from_string(self, name: str, raw: str):
        if name not in self.decls:
            raise ParamError(f"unknown parameter '{name}'")
        self.values[name] = self._convert(self.decls[name], raw)
        self._set_from_file.add(name)

    def parse_string(self, text: str, strict: bool = True):
        for lineno, line in enumerate(text.splitlines(), start=1):
            # strip comments: both # and % are comment chars in gadget files
            for cc in "#%":
                idx = line.find(cc)
                if idx >= 0:
                    line = line[:idx]
            line = line.strip()
            if not line:
                continue
            if "=" not in line:
                raise ParamError(f"line {lineno}: expected 'key = value', "
                                 f"got '{line}'")
            key, _, raw = line.partition("=")
            key = key.strip()
            raw = raw.strip()
            if key not in self.decls:
                if strict:
                    raise ParamError(f"line {lineno}: unknown parameter "
                                     f"'{key}'")
                continue
            self.set_from_string(key, raw)
        # check required
        missing = [d.name for d in self.decls.values()
                   if d.required == REQUIRED and d.name not in self.values]
        if missing:
            raise ParamError(f"missing required parameters: {missing}")

    def parse_file(self, path: str, strict: bool = True):
        with open(path) as f:
            self.parse_string(f.read(), strict=strict)

    # ---- getters ----
    def is_set(self, name: str) -> bool:
        return name in self._set_from_file

    def get_int(self, name: str) -> int:
        return int(self.values[name])

    def get_double(self, name: str) -> float:
        return float(self.values[name])

    def get_string(self, name: str) -> str:
        return str(self.values[name])

    def get_enum(self, name: str) -> int:
        return self.values[name]

    def format_help(self) -> str:
        lines = []
        for d in self.decls.values():
            req = "REQUIRED" if d.required else f"default={d.default}"
            lines.append(f"{d.name} ({d.ptype}, {req}): {d.help}")
        return "\n".join(lines)


def build_output_list(outputliststr: str):
    """Parse a comma-separated list of output scale factors, sorted.

    Behavior matches the reference's output-list parser
    (libgadget/timebinmgr.h BuildOutputList): quoted tokens allowed,
    negative values rejected, result sorted ascending.
    """
    out = []
    if not outputliststr:
        return out
    for token in outputliststr.split(","):
        token = token.strip().strip('"')
        if not token:
            continue
        a = float(token)
        if a < 0:
            raise ParamError(f"negative output time {a}")
        out.append(a)
    return sorted(out)
