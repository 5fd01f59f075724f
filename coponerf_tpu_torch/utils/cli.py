"""Minimal configargparse replacement: argparse + optional ``-c`` config file
of ``key = value`` lines (the subset the reference uses, train.py:24-25).
The port's copy of ``coponerf_tpu/utils/cli.py``."""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional


def parse_with_config(parser: argparse.ArgumentParser, argv: Optional[List[str]] = None):
    argv = list(sys.argv[1:] if argv is None else argv)
    cfg_path = None
    for flag in ("-c", "--config_filepath"):
        if flag in argv:
            i = argv.index(flag)
            cfg_path = argv[i + 1]
            del argv[i: i + 2]
    file_args: List[str] = []
    if cfg_path:
        with open(cfg_path) as f:
            for line in f:
                line = line.split("#")[0].strip()
                if not line:
                    continue
                if "=" in line:
                    k, v = (s.strip() for s in line.split("=", 1))
                else:
                    parts = line.split(None, 1)
                    k, v = parts[0], (parts[1] if len(parts) > 1 else "")
                k = k.lstrip("-")
                if v.lower() in ("true",):
                    file_args.append(f"--{k}")
                elif v.lower() in ("false", ""):
                    continue
                else:
                    file_args.extend([f"--{k}", v])
    # CLI args override config-file args
    return parser.parse_args(file_args + argv)
