"""Command line: ``python -m graphtpu_torch.cli run ...`` (counterpart of
``graphtpu.cli run``, the execute-job.sh analogue). It loads the graph,
warms up outside the processing window, runs one algorithm job, and
optionally writes and validates the output.
"""

from __future__ import annotations

import argparse
import sys


def cmd_run(args) -> int:
    from graphtpu_torch.harness.platform import GraphTorchPlatform
    from graphtpu_torch.harness.validator import validate_result
    from graphtpu_torch.utils.config import GraphSpec, PlatformConfig

    cfg = (
        PlatformConfig.from_properties(args.platform_properties)
        if args.platform_properties
        else PlatformConfig()
    )
    cfg.intermediate_dir = args.intermediate_dir
    for attr in ("device", "precision", "cdlp_impl"):
        if getattr(args, attr):
            setattr(cfg, attr, getattr(args, attr))

    spec = GraphSpec.from_properties(args.graph_properties)
    platform = GraphTorchPlatform(cfg)
    platform.verify_setup()
    platform.startup(log_dir=args.log_path)
    graph = platform.load_graph(spec)
    platform.prepare(spec, args.algorithm)
    result = platform.run(spec, args.algorithm)
    metrics = platform.finalize()
    print(f"processing time: {metrics.processing_time_seconds}s "
          f"(iterations: {result.iterations})")
    if args.output_file:
        result.write(graph, args.output_file)
        print(f"output written to {args.output_file}")
    if args.validation_file:
        ok, msg = validate_result(result, graph, args.validation_file)
        print(f"validation: {'PASS' if ok else 'FAIL'} ({msg})")
        return 0 if ok else 1
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="graphtpu_torch",
        description="LDBC Graphalytics on PyTorch and CUDA (BFS, PageRank, WCC, CDLP, LCC, SSSP)",
    )
    sub = ap.add_subparsers(dest="command", required=True)
    p = sub.add_parser("run", help="run one algorithm job (execute-job.sh analogue)")
    p.add_argument("--graph-properties", required=True)
    p.add_argument("--algorithm", required=True, choices=["bfs", "pr", "wcc", "cdlp", "lcc", "sssp"])
    p.add_argument("--output-file", default=None)
    p.add_argument("--validation-file", default=None)
    p.add_argument("--log-path", default=None)
    p.add_argument("--intermediate-dir", default="./intermediate")
    p.add_argument("--device", default=None, help="torch device (default: cuda)")
    p.add_argument("--precision", choices=["float32", "float64"], default=None)
    p.add_argument("--cdlp-impl", choices=["auto", "slab", "sort"], default=None)
    p.add_argument("--platform-properties", default=None,
                   help="platform.properties file (flags override it)")
    p.set_defaults(fn=cmd_run)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
