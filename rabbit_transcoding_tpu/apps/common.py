"""Shared CLI plumbing for the apps (program-options-lite-style UX)."""

from __future__ import annotations

import sys

from ..utils.compile_cache import enable_compile_cache
from ..utils.config import OptionRegistry
from ..utils.timing import Stopwatch, print_run_footer

# every app starts here: keep compiled programs across processes
enable_compile_cache()


def build_registry(params, extra: dict[str, tuple] | None = None) -> OptionRegistry:
    """Registry bound to a params dataclass; `extra` adds (default, help)."""
    reg = OptionRegistry()
    reg.add("help", False, "print help and exit")
    reg.add("configurationFolder", "", "base folder prepended to -c paths")
    reg.declare_dataclass(params)
    for name, (default, help_) in (extra or {}).items():
        reg.add(name, default, help_)
    return reg


def parse_or_help(reg: OptionRegistry, argv, params, title: str):
    reg.parse_args(list(argv))
    if reg["help"]:
        print(reg.help_text(title))
        return None
    for w in reg.warnings:
        print(f"warning: {w}", file=sys.stderr)
    reg.apply_to_dataclass(params)
    return params


def run_app(name: str, fn) -> int:
    """Run an app body under the reference-style wall/user/memory footer."""
    sw = Stopwatch()
    with sw.timing():
        rc = fn()
    print_run_footer(name, sw)
    return rc
