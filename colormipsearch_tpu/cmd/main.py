"""CLI dispatcher.

Counterpart of cmd/Main.java:25-97: one multi-command entry point. Run as
`python -m colormipsearch_tpu <command> ...`.
"""

from __future__ import annotations

import argparse
import logging
import sys
from typing import List, Optional


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="colormipsearch-tpu",
        description="Accelerator-native color depth MIP search tools")
    parser.add_argument("-v", "--verbose", action="store_true")
    subparsers = parser.add_subparsers(dest="command")

    from . import (colordepthsearch_cmd, gradientscores_cmd, normalize_cmd,
                   createdatainput_cmd, importppp_cmd, exportdata_cmd,
                   tag_cmd, copymips_cmd, validate_cmd, delete_cmd)
    for mod in (colordepthsearch_cmd, gradientscores_cmd, normalize_cmd,
                createdatainput_cmd, importppp_cmd, exportdata_cmd,
                tag_cmd, copymips_cmd, validate_cmd, delete_cmd):
        mod.add_parser(subparsers)
    return parser


def main(argv: Optional[List[str]] = None) -> int:
    from ..utils.compile_cache import configure_compile_cache
    configure_compile_cache()
    parser = build_parser()
    args = parser.parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s - %(message)s")
    if not args.command:
        parser.print_help()
        return 1
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
