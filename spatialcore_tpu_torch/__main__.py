"""Command-line interface: ``python -m spatialcore_tpu_torch <command>``.

Commands
--------
info                       module availability report
pipeline CONFIG.yaml       train_and_annotate driven by a TrainingConfig
moran    IN.h5ad           global Moran's I over an h5ad
benchmark IN.h5ad          annotation quality metrics
domains  IN.h5ad EXPR      spatial domains for a filter expression

``--device`` (before or after the command; default ``cuda``) picks where
the numeric work runs: ``cpu`` runs every command without a card.
"""

from __future__ import annotations

import argparse


def _load(path):
    from .core.io import read_h5ad

    return read_h5ad(path)


def _save(adata, path):
    from .core.io import write_h5ad

    write_h5ad(adata, path)
    print(f"wrote {path}")


def cmd_info(_args):
    from . import print_info

    print_info()


def cmd_pipeline(args):
    from .annotation import TrainingConfig, train_and_annotate

    config = TrainingConfig.from_yaml(args.config)
    adata = _load(args.adata)
    adata, model = train_and_annotate(adata, config=config,
                                      device=args.device)
    summary = adata.uns["spatialcore_annotation"]
    print(f"annotated {adata.n_obs:,} cells → {summary['n_types']} types "
          f"({summary['unassigned_pct']}% unassigned)")
    _save(adata, args.out)


def cmd_moran(args):
    adata = _load(args.adata)
    genes = args.genes.split(",") if args.genes else None
    if args.geary:
        # fused pass: Moran's I + Geary's C from one permutation scan
        from .spatial import global_autocorrelation

        adata = global_autocorrelation(
            adata, genes=genes, n_neighbors=args.k,
            n_permutations=args.permutations, seed=args.seed,
            device=args.device)
        df = adata.uns["morans_i"].merge(
            adata.uns["gearys_c"][["gene", "C", "p_value"]]
            .rename(columns={"p_value": "p_value_C"}), on="gene")
        df = df.sort_values("I", ascending=False)
    else:
        from .spatial import morans_i

        adata = morans_i(adata, genes=genes, n_neighbors=args.k,
                         n_permutations=args.permutations, seed=args.seed,
                         device=args.device)
        df = adata.uns["morans_i"].sort_values("I", ascending=False)
    print(df.head(args.top).to_string(index=False))
    if args.out:
        _save(adata, args.out)


def cmd_benchmark(args):
    from .annotation.benchmark import benchmark_annotation, compare_annotation_methods

    adata = _load(args.adata)
    cols = args.columns.split(",")
    if len(cols) == 1:
        s = benchmark_annotation(adata, cols[0], store=False,
                                 device=args.device)
        print(s.round(4).to_string())
    else:
        t = compare_annotation_methods(adata, cols, device=args.device)
        print(t.round(4).to_string())


def cmd_domains(args):
    from .spatial import get_domain_summary, make_spatial_domains

    adata = _load(args.adata)
    adata = make_spatial_domains(adata, args.filter,
                                 platform=args.platform or None,
                                 device=args.device)
    print(get_domain_summary(adata).to_string(index=False))
    if args.out:
        _save(adata, args.out)


def main(argv=None):
    p = argparse.ArgumentParser(prog="spatialcore_tpu_torch",
                                description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default="cuda",
                   help="torch device for the numeric work (default: cuda)")
    # --device also after the command; it overrides only when given there
    dev = argparse.ArgumentParser(add_help=False)
    dev.add_argument("--device", default=argparse.SUPPRESS,
                     help="torch device for the numeric work")
    sub = p.add_subparsers(dest="command", required=True)

    sub.add_parser("info", help="module availability", parents=[dev])

    pp = sub.add_parser("pipeline", help="train_and_annotate from YAML",
                        parents=[dev])
    pp.add_argument("config")
    pp.add_argument("--adata", required=True, help="query h5ad")
    pp.add_argument("--out", required=True, help="output h5ad")

    pm = sub.add_parser("moran", help="global Moran's I", parents=[dev])
    pm.add_argument("adata")
    pm.add_argument("--genes", default=None,
                    help="comma-separated (default: all)")
    pm.add_argument("--k", type=int, default=6)
    pm.add_argument("--permutations", type=int, default=100)
    pm.add_argument("--seed", type=int, default=0)
    pm.add_argument("--top", type=int, default=20)
    pm.add_argument("--geary", action="store_true",
                    help="also Geary's C, fused into the same "
                         "permutation scan")
    pm.add_argument("--out", default=None)

    pb = sub.add_parser("benchmark",
                        help="annotation quality metrics (7-metric table)",
                        parents=[dev])
    pb.add_argument("adata")
    pb.add_argument("--columns", default="cell_type",
                    help="obs annotation column(s), comma-separated; two "
                         "or more produces the method-comparison table")

    pd_ = sub.add_parser("domains", help="spatial domains", parents=[dev])
    pd_.add_argument("adata")
    pd_.add_argument("filter", help="filter expression (e.g. CL:0000236)")
    pd_.add_argument("--platform", default=None,
                     choices=["cosmx", "xenium", "visium"])
    pd_.add_argument("--out", default=None)

    args = p.parse_args(argv)
    {"info": cmd_info, "pipeline": cmd_pipeline, "moran": cmd_moran,
     "domains": cmd_domains, "benchmark": cmd_benchmark}[args.command](args)


if __name__ == "__main__":
    main()
