"""Training-data discovery over local filesystems (and ``gs://`` when
gcsfs is installed).

Port of ``spatialcore_tpu/annotation/discovery.py`` (host Python, so a
copy): ``discover_training_data`` (local glob, or a ``gs://`` listing with
retries through a lazily imported ``gcsfs``), ``DiscoveredDataset`` and the
metadata CSV helpers.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Union

import pandas as pd

from ..core.compat import param_aliases
from ..core.logging import get_logger

logger = get_logger("annotation.discovery")


@dataclass
class DiscoveredDataset:
    uri: str
    name: str
    size_bytes: Optional[int] = None
    source: str = "local"
    metadata: Dict = field(default_factory=dict)

    @property
    def size_gb(self) -> Optional[float]:
        return round(self.size_bytes / 1e9, 3) if self.size_bytes else None


@param_aliases(path="root")
def discover_training_data(
    root: Union[str, Path],
    pattern: str = "*.h5ad",
    recursive: bool = True,
    max_retries: int = 3,
) -> List[DiscoveredDataset]:
    """List candidate reference datasets under a local dir or gs:// prefix."""
    root_s = str(root)
    if root_s.startswith("gs://"):
        try:
            import gcsfs
        except ImportError as e:
            raise ImportError(
                "gs:// discovery requires the optional 'gcsfs' dependency"
            ) from e
        fs = gcsfs.GCSFileSystem()
        prefix = root_s[len("gs://"):]
        last_err = None
        for attempt in range(max_retries):
            try:
                glob = f"{prefix}/**/{pattern}" if recursive else \
                    f"{prefix}/{pattern}"
                hits = fs.glob(glob)
                out = []
                for h in hits:
                    info = fs.info(h)
                    out.append(DiscoveredDataset(
                        uri=f"gs://{h}", name=Path(h).stem,
                        size_bytes=info.get("size"), source="gcs"))
                logger.info(f"Discovered {len(out)} datasets under {root_s}")
                return out
            except Exception as e:  # transient GCS errors: retry
                last_err = e
                time.sleep(2 ** attempt)
        raise RuntimeError(
            f"GCS discovery failed after {max_retries} retries: {last_err}")

    root_p = Path(root_s)
    if not root_p.exists():
        raise FileNotFoundError(f"Discovery root not found: {root_p}")
    paths = sorted(root_p.rglob(pattern) if recursive
                   else root_p.glob(pattern))
    out = [DiscoveredDataset(uri=str(p), name=p.stem,
                             size_bytes=p.stat().st_size, source="local")
           for p in paths]
    logger.info(f"Discovered {len(out)} datasets under {root_p}")
    return out


def make_metadata_template(
    datasets: List[DiscoveredDataset],
    path: Optional[Union[str, Path]] = None,
) -> pd.DataFrame:
    """CSV template for curating discovered datasets (tissue/labels/notes)."""
    df = pd.DataFrame([{
        "name": d.name, "uri": d.uri, "size_gb": d.size_gb,
        "source": d.source, "tissue": "", "cell_type_column": "cell_type",
        "include": True, "notes": "",
    } for d in datasets])
    if path:
        p = Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        df.to_csv(p, index=False)
        logger.info(f"Metadata template → {p}")
    return df


def query_metadata(
    metadata_csv: Union[str, Path],
    tissue: Optional[str] = None,
    include_only: bool = True,
) -> pd.DataFrame:
    """Filter a curated metadata CSV back down to reference URIs."""
    df = pd.read_csv(metadata_csv)
    if include_only and "include" in df.columns:
        df = df[df["include"].astype(bool)]
    if tissue and "tissue" in df.columns:
        df = df[df["tissue"].astype(str).str.lower() == tissue.lower()]
    return df.reset_index(drop=True)


def print_discovery_summary(datasets) -> None:
    """Human-readable table of discovered datasets."""
    if not datasets:
        print("No datasets discovered.")
        return
    total = sum(d.size_bytes or 0 for d in datasets)
    print(f"{len(datasets)} datasets ({total / 1e9:.2f} GB total)")
    for d in sorted(datasets, key=lambda x: -(x.size_bytes or 0)):
        size = f"{d.size_gb:.2f} GB" if d.size_gb else "?"
        print(f"  {d.name:40s} {size:>10s}  {d.source}  {d.uri}")


def query_local_references(
    metadata_df,
    tissue: Optional[str] = None,
    condition: Optional[str] = None,
    min_cells: int = 1000,
    file_column: str = "file_path",
    tissue_column: str = "tissue",
    condition_column: str = "condition",
    cells_column: str = "n_cells",
    pattern: str = "*.h5ad",
) -> pd.DataFrame:
    """Filter reference metadata by tissue / condition / cell count.

    ``metadata_df`` is the frame from :func:`load_local_metadata`; a
    path-like first argument instead discovers h5ad files under it and
    builds the frame on the fly.
    """
    if not isinstance(metadata_df, pd.DataFrame):
        datasets = discover_training_data(metadata_df, pattern=pattern)
        metadata_df = pd.DataFrame([{
            file_column: d.uri, "name": d.name,
            tissue_column: d.metadata.get("tissue", ""),
            condition_column: d.metadata.get("condition", ""),
            cells_column: d.metadata.get("n_cells"),
        } for d in datasets])
        min_cells = 0  # discovery carries no cell counts
    df = metadata_df
    if tissue is not None and tissue_column in df.columns:
        df = df[df[tissue_column].astype(str).str.lower()
                .str.contains(tissue.lower(), regex=False)]
    if condition is not None and condition_column in df.columns:
        df = df[df[condition_column].astype(str).str.lower()
                == condition.lower()]
    if min_cells and cells_column in df.columns:
        counts = pd.to_numeric(df[cells_column], errors="coerce")
        df = df[counts.fillna(0) >= min_cells]
    if file_column in df.columns:
        missing = [p for p in df[file_column]
                   if not str(p).startswith(("gs://", "s3://"))
                   and not Path(str(p)).exists()]
        if missing:
            logger.warning(f"{len(missing)} referenced files not found "
                           f"(first: {missing[0]})")
    return df.reset_index(drop=True)


def load_local_metadata(
    metadata_csv: Union[str, Path],
    sample_csv: Optional[Union[str, Path]] = None,
):
    """Read curated reference metadata (+ optional sample summary) CSVs.

    Returns ``(metadata_df, sample_df_or_None)``.
    """
    metadata_csv = Path(metadata_csv)
    if not metadata_csv.exists():
        raise FileNotFoundError(f"Metadata CSV not found: {metadata_csv}")
    metadata_df = pd.read_csv(metadata_csv)
    sample_df = None
    if sample_csv is not None:
        sample_csv = Path(sample_csv)
        if not sample_csv.exists():
            raise FileNotFoundError(f"Sample CSV not found: {sample_csv}")
        sample_df = pd.read_csv(sample_csv)
    return metadata_df, sample_df


@param_aliases(path="output_path", datasets="discovered_datasets")
def create_metadata_template(
    output_path: Union[str, Path],
    discovered_datasets: Optional[List[DiscoveredDataset]] = None,
) -> Path:
    """Write a metadata CSV template, optionally pre-populated from
    :func:`discover_training_data`."""
    output_path = Path(output_path)
    if discovered_datasets:
        rows = [{
            "file_path": d.uri, "name": d.name, "tissue": "",
            "condition": "", "n_cells": None,
            "label_column": "cell_type", "notes": "",
        } for d in discovered_datasets]
    else:
        rows = [{"file_path": "", "name": "", "tissue": "",
                 "condition": "", "n_cells": None,
                 "label_column": "cell_type", "notes": ""}]
    output_path.parent.mkdir(parents=True, exist_ok=True)
    pd.DataFrame(rows).to_csv(output_path, index=False)
    logger.info(f"Metadata template → {output_path}")
    return output_path
