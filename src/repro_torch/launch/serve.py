"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id> [...]``.

Closed loop: boots an AgentServe engine for the selected architecture
(its reduced smoke variant, or the full published config with
``--full``), serves a multi-agent ToolBench-like workload and prints the
per-policy report row.  Runs on the CUDA card unless ``--device cpu`` is
given; weights are random, drawn on the device from ``--seed``.  The
online gateway (``--serve``) is not ported yet.
"""
from __future__ import annotations

import argparse
import sys
from typing import List, Tuple

import torch

from repro_torch.configs.base import get_config, get_smoke_config
from repro_torch.models import init_params
from repro_torch.serving.engine import (EngineConfig, ServingEngine,
                                        resolve_device)
from repro_torch.serving.metrics import ServingReport
from repro_torch.serving.policies import PLANNERS, POLICIES
from repro_torch.serving.request import Session
from repro_torch.serving.workload import make_workload

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def build_engine(args, policy: str) -> Tuple[ServingEngine, object]:
    """One engine for the parsed launcher arguments."""
    device = resolve_device(args.device)
    cfg = (get_config if args.full else get_smoke_config)(args.arch)
    dtype = DTYPES[args.dtype or ("bfloat16" if device.type == "cuda"
                                  else "float32")]
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = init_params(cfg, gen, dtype)
    ecfg = EngineConfig(num_slots=args.num_slots or max(args.agents + 2, 6),
                        max_seq=args.max_seq, cycle_budget=160,
                        granularity=16, control_interval_s=0.1)
    return ServingEngine(cfg, params, PLANNERS[policy], ecfg, dtype=dtype,
                         device=device), cfg


def closed_loop(args) -> List[Tuple[ServingEngine, List[Session],
                                    ServingReport]]:
    """Run the closed-loop workload under each requested policy and
    print one report row per policy.  Returns (engine, sessions, report)
    per policy."""
    policies = sorted(POLICIES) if args.compare else [args.policy]
    print(ServingReport.HEADER, flush=True)
    out = []
    for policy in policies:
        eng, cfg = build_engine(args, policy)
        sessions = make_workload(
            args.agents, workload=args.workload, vocab_size=cfg.vocab_size,
            token_scale=args.token_scale, num_system_prompts=1,
            seed=args.seed)
        rep = eng.run(sessions)
        print(rep.row(), flush=True)
        out.append((eng, sessions, rep))
    return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--policy", default="agentserve",
                    choices=sorted(PLANNERS))
    ap.add_argument("--agents", type=int, default=4)
    ap.add_argument("--workload", default="react",
                    choices=["react", "plan_execute"])
    ap.add_argument("--token-scale", type=float, default=0.125)
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights and the workload")
    ap.add_argument("--compare", action="store_true",
                    help="run every policy on the same workload")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (default) raises when no card is present")
    ap.add_argument("--dtype", default=None, choices=sorted(DTYPES),
                    help="default: bfloat16 on cuda, float32 on cpu")
    ap.add_argument("--max-seq", type=int, default=1024,
                    help="KV rows per slot (the last is the scratch row)")
    ap.add_argument("--num-slots", type=int, default=0,
                    help="KV slots (default: max(agents + 2, 6))")
    ap.add_argument("--full", action="store_true",
                    help="the architecture's full published config instead "
                         "of its reduced smoke variant")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    closed_loop(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
