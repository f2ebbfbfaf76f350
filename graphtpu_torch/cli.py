"""Command line: ``python -m graphtpu_torch.cli load|run|validate|benchmark|download|devices``
(counterpart of ``graphtpu.cli``).

The reference drives its lifecycle through shell scripts
(bin/sh/{load-graph,execute-job,unload-graph}.sh under a Java harness);
here the same surface is subcommands of one CLI. ``run`` is the
execute-job.sh analogue: it loads the graph, warms up outside the
processing window, runs one algorithm job, and optionally writes and
validates the output. ``benchmark`` runs a suite from a benchmark.properties
file, each job in a killable child process by default. ``download`` fetches
Graphalytics dataset archives (download-dataset-small.sh).
"""

from __future__ import annotations

import argparse
import json
import sys

ALGORITHMS = ["bfs", "pr", "wcc", "cdlp", "lcc", "sssp"]


def _add_platform_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--intermediate-dir", default="./intermediate")
    p.add_argument("--device", default=None, help="torch device (default: cuda)")
    p.add_argument("--precision", choices=["float32", "float64"], default=None)
    p.add_argument("--cdlp-impl", choices=["auto", "slab", "sort"], default=None)
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace of each processing window here")
    p.add_argument("--platform-properties", default=None,
                   help="platform.properties file (flags override it)")


def _platform_config(args):
    from graphtpu_torch.utils.config import PlatformConfig

    cfg = (
        PlatformConfig.from_properties(args.platform_properties)
        if args.platform_properties
        else PlatformConfig()
    )
    cfg.intermediate_dir = args.intermediate_dir
    for attr in ("device", "precision", "cdlp_impl", "profile_dir"):
        if getattr(args, attr):
            setattr(cfg, attr, getattr(args, attr))
    return cfg


def cmd_load(args) -> int:
    from graphtpu_torch.ingest.loader import load_graph, load_graph_from_spec
    from graphtpu_torch.utils.config import GraphSpec

    if args.graph_properties:
        spec = GraphSpec.from_properties(args.graph_properties)
        g = load_graph_from_spec(spec, intermediate_dir=args.intermediate_dir)
    else:
        if not (args.input_vertex_path and args.input_edge_path and args.graph_name):
            print("load: need --graph-properties OR --graph-name + --input-vertex-path + "
                  "--input-edge-path", file=sys.stderr)
            return 2
        g = load_graph(args.input_vertex_path, args.input_edge_path, args.directed,
                       args.weighted, graph_name=args.graph_name,
                       intermediate_dir=args.intermediate_dir)
    print(f"loaded {g}")
    return 0


def cmd_run(args) -> int:
    from graphtpu_torch.harness.platform import GraphTorchPlatform
    from graphtpu_torch.harness.validator import validate_result
    from graphtpu_torch.utils.config import GraphSpec

    spec = GraphSpec.from_properties(args.graph_properties)
    platform = GraphTorchPlatform(_platform_config(args))
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


def cmd_validate(args) -> int:
    from graphtpu_torch.harness.validator import validate_files

    ok, msg = validate_files(args.algorithm, args.output_file, args.validation_file)
    print(f"validation: {'PASS' if ok else 'FAIL'} ({msg})")
    return 0 if ok else 1


def cmd_benchmark(args) -> int:
    from graphtpu_torch.harness.suite import BenchmarkSuite
    from graphtpu_torch.utils.config import BenchmarkConfig

    bench_cfg = BenchmarkConfig.from_properties(args.config)
    if args.graphs:
        bench_cfg.graphs = args.graphs.split(",")
    if args.algorithms:
        bench_cfg.algorithms = args.algorithms.lower().split(",")
    records = BenchmarkSuite(bench_cfg, _platform_config(args)).run()
    bad = [r for r in records if not (r.success and r.validated in (True, None))]
    print(f"benchmark finished: {len(records) - len(bad)}/{len(records)} runs ok; "
          f"report at {bench_cfg.report_dir}")
    return 1 if bad else 0


def cmd_download(args) -> int:
    import tarfile

    from graphtpu_torch.ingest.download import (
        DEFAULT_BASE_URL, SMALL_DATASETS, download_dataset, download_small_datasets,
    )

    base_url = args.base_url or DEFAULT_BASE_URL
    try:
        if args.all_small:
            for p in download_small_datasets(args.graphs_dir, base_url=base_url,
                                             force=args.force):
                print(f"ready: {p}")
            return 0
        if not args.graph:
            print(f"download: need --graph <name> (known: {', '.join(SMALL_DATASETS)}) "
                  "or --all-small", file=sys.stderr)
            return 2
        p = download_dataset(args.graph, args.graphs_dir, base_url=base_url, url=args.url,
                             force=args.force)
        print(f"ready: {p}")
        return 0
    except (OSError, ValueError, EOFError, ImportError, tarfile.TarError) as e:
        # OSError: network or file system; TarError, EOFError: a corrupt or
        # truncated archive; ValueError: a member that escapes the directory;
        # ImportError: a .zst archive without the zstandard module
        print(f"download failed: {e}", file=sys.stderr)
        return 1


def cmd_devices(args) -> int:
    """The CUDA cards this process sees, or the CPU when there are none."""
    import torch

    if torch.cuda.is_available():
        names = [torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]
        info = {"backend": "cuda", "num_devices": len(names), "devices": names}
    else:
        info = {"backend": "cpu", "num_devices": 1, "devices": ["cpu"]}
    print(json.dumps(info))
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="graphtpu_torch",
        description="LDBC Graphalytics on PyTorch and CUDA (BFS, PageRank, WCC, CDLP, LCC, SSSP)",
    )
    sub = ap.add_subparsers(dest="command", required=True)

    p = sub.add_parser("load", help="ingest a graph into the binary cache (load-graph.sh analogue)")
    p.add_argument("--graph-properties", default=None, help="dataset descriptor .properties file")
    p.add_argument("--graph-name", default=None)
    p.add_argument("--input-vertex-path", default=None)
    p.add_argument("--input-edge-path", default=None)
    p.add_argument("--directed", action="store_true")
    p.add_argument("--weighted", action="store_true")
    p.add_argument("--intermediate-dir", default="./intermediate")
    p.set_defaults(fn=cmd_load)

    p = sub.add_parser("run", help="run one algorithm job (execute-job.sh analogue)")
    p.add_argument("--graph-properties", required=True)
    p.add_argument("--algorithm", required=True, choices=ALGORITHMS)
    p.add_argument("--output-file", default=None)
    p.add_argument("--validation-file", default=None)
    p.add_argument("--log-path", default=None)
    _add_platform_flags(p)
    p.set_defaults(fn=cmd_run)

    p = sub.add_parser("validate", help="validate an output file against a golden file")
    p.add_argument("--algorithm", required=True, choices=ALGORITHMS)
    p.add_argument("--output-file", required=True)
    p.add_argument("--validation-file", required=True)
    p.set_defaults(fn=cmd_validate)

    p = sub.add_parser("benchmark", help="run a benchmark suite from a properties file")
    p.add_argument("--config", required=True, help="benchmark.properties")
    p.add_argument("--graphs", default=None, help="comma list, overrides config")
    p.add_argument("--algorithms", default=None, help="comma list, overrides config")
    _add_platform_flags(p)
    p.set_defaults(fn=cmd_benchmark)

    p = sub.add_parser("download",
                       help="fetch Graphalytics dataset archives (download-dataset-small.sh analogue)")
    p.add_argument("--graph", default=None, help="dataset name (e.g. datagen-7_5-fb)")
    p.add_argument("--all-small", action="store_true",
                   help="fetch the reference's full small-data-set list")
    p.add_argument("--graphs-dir", default="./graphs")
    p.add_argument("--base-url", default=None)
    p.add_argument("--url", default=None,
                   help="explicit archive URL (.tar.zst/.tar.gz/.tar; file:// supported)")
    p.add_argument("--force", action="store_true", help="re-download even if present")
    p.set_defaults(fn=cmd_download)

    p = sub.add_parser("devices", help="show the devices torch sees")
    p.set_defaults(fn=cmd_devices)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
