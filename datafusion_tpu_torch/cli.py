"""Interactive SQL shell (port of datafusion_tpu/cli.py; capability analog
of datafusion-cli, datafusion-cli/src/{main.rs:181, exec.rs:129}).

Usage:
  python -m datafusion_tpu_torch.cli                # REPL on the CUDA card
  python -m datafusion_tpu_torch.cli -f script.sql  # run a file
  python -m datafusion_tpu_torch.cli -c "SELECT 1"  # run a command
  python -m datafusion_tpu_torch.cli --cpu          # run on the CPU

Without --cpu the session runs on the CUDA card and raises when there is
none, as SessionContext() does.

Dot-commands: \\d [table], \\q, \\timing on|off, \\tpch SF (load TPC-H data).
"""
from __future__ import annotations

import argparse
import sys
import time


def _print_result(df, timing: bool, t0: float):
    table = df.collect()
    elapsed = time.perf_counter() - t0
    pdf = table.to_pandas()
    if len(pdf):
        print(pdf.to_string(index=False))
    print(f"{table.num_rows} row(s)" + (f" in {elapsed:.3f}s" if timing else ""))


def run_statement(ctx, sql: str, timing: bool):
    t0 = time.perf_counter()
    df = ctx.sql(sql)
    _print_result(df, timing, t0)


def handle_dot(ctx, line: str, state) -> bool:
    """Returns False to quit."""
    parts = line.strip().split()
    cmd = parts[0]
    if cmd in ("\\q", "\\quit", "exit", "quit"):
        return False
    if cmd == "\\d":
        if len(parts) > 1:
            provider = ctx.catalog.get(parts[1])
            for f in provider.schema().fields:
                print(f"  {f.name}: {f.dtype}{'' if f.nullable else ' NOT NULL'}")
        else:
            for name in ctx.catalog.names():
                print(f"  {name}")
    elif cmd == "\\timing":
        state["timing"] = len(parts) < 2 or parts[1] != "off"
        print(f"timing {'on' if state['timing'] else 'off'}")
    elif cmd == "\\tpch":
        sf = float(parts[1]) if len(parts) > 1 else 0.01
        from .models.tpch.datagen import register_tpch

        t0 = time.perf_counter()
        register_tpch(ctx, sf)
        print(f"TPC-H sf={sf} registered in {time.perf_counter() - t0:.1f}s")
    else:
        print(f"unknown command {cmd}; try \\d, \\timing, \\tpch, \\q")
    return True


def main(argv=None):
    ap = argparse.ArgumentParser(description="datafusion-tpu SQL shell (PyTorch)")
    ap.add_argument("-f", "--file", help="run SQL from file")
    ap.add_argument("-c", "--command", help="run a single SQL command")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = ap.parse_args(argv)

    from . import SessionContext
    from .common.errors import DataFusionTpuError

    ctx = SessionContext(device="cpu" if args.cpu else None)
    state = {"timing": True}

    if args.command:
        run_statement(ctx, args.command, state["timing"])
        return 0
    if args.file:
        with open(args.file) as f:
            sql = f.read()
        run_statement(ctx, sql, state["timing"])
        return 0

    print(f"datafusion-tpu SQL shell (device: {ctx.device}); \\q to quit")
    buf = []
    while True:
        try:
            prompt = "> " if not buf else ". "
            line = input(prompt)
        except (EOFError, KeyboardInterrupt):
            print()
            break
        if not buf and line.strip().startswith("\\") or line.strip() in ("exit", "quit"):
            if not handle_dot(ctx, line, state):
                break
            continue
        if not line.strip():
            continue
        buf.append(line)
        if line.rstrip().endswith(";"):
            sql = "\n".join(buf)
            buf = []
            try:
                run_statement(ctx, sql, state["timing"])
            except DataFusionTpuError as e:
                print(f"Error: {e}")
            except Exception as e:  # noqa: BLE001
                print(f"Internal error: {type(e).__name__}: {e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
