"""Clinical tabular loaders (ADNI_Tabel.csv), read with the csv module.

Own copy of the TPU package's data/tabular.py, which reads the table with
pandas; the card's machine has none. `read_table` reproduces the part of
pandas' `read_csv` type inference the loaders rely on:

- a cell in pandas' default NA set (empty, "NA", "NaN", "null", ...) is
  missing;
- a column whose every present cell reads as a number is numeric (float64,
  NaN where missing); any other column is text (the cells' strings, None
  where missing), and the loaders encode it as `pd.Categorical(...).codes`
  does: the index in the sorted distinct strings, -1 where missing.

Types are inferred over all rows of the file; the codes are taken over the
rows the loader keeps, as the TPU package filters before encoding. The
loaders then select feature columns from `start_col` on (the label column
excluded), keep the requested classes, map class names to 0..k-1 and return
(X float32, y int64[, feature columns]).
"""

from __future__ import annotations

import csv

import numpy as np

#: pandas' default missing-value strings (`read_csv`'s na_values)
NA_VALUES = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND",
    "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null"})


def _number(cell: str) -> float:
    if "_" in cell:  # Python reads "1_000"; pandas does not
        raise ValueError(cell)
    return float(cell)


def _infer_column(cells: list):
    """float64 array if every present cell is a number, else an object
    array of the strings with None where missing."""
    present = [c for c in cells if c not in NA_VALUES]
    try:
        values = [_number(c) for c in present]
    except ValueError:
        return np.array([None if c in NA_VALUES else c for c in cells], dtype=object)
    out = np.full(len(cells), np.nan)
    out[[i for i, c in enumerate(cells) if c not in NA_VALUES]] = values
    return out


def read_table(csv_path: str, str_columns=()) -> tuple[list, dict]:
    """(column names, {name: column}) of a CSV file; `str_columns` are read
    as text whatever their cells (pandas' ``dtype={col: str}``)."""
    with open(csv_path, newline="", encoding="utf-8") as f:
        rows = list(csv.reader(f))
    if not rows:
        raise ValueError(f"{csv_path} is empty")
    header, body = rows[0], rows[1:]
    names, seen = [], {}
    for name in header:  # pandas renames a repeated name to name.1, name.2, ...
        if name in seen:
            seen[name] += 1
            name = f"{name}.{seen[name]}"
        else:
            seen[name] = 0
        names.append(name)
    columns = {}
    for j, name in enumerate(names):
        cells = [r[j] if j < len(r) else "" for r in body]
        if name in str_columns:
            columns[name] = np.array([None if c in NA_VALUES else c for c in cells],
                                     dtype=object)
        else:
            columns[name] = _infer_column(cells)
    return names, columns


def is_text(column: np.ndarray) -> bool:
    return column.dtype == object


def category_codes(column: np.ndarray) -> np.ndarray:
    """`pd.Categorical(column).codes`: the index of each value in the sorted
    distinct values, -1 where missing."""
    present = [v for v in column if v is not None]
    lookup = {v: i for i, v in enumerate(sorted(set(present)))}
    return np.array([-1 if v is None else lookup[v] for v in column], np.int64)


def isin(column: np.ndarray, values) -> np.ndarray:
    """pandas' `Series.isin` of a text or numeric column."""
    if is_text(column):
        wanted = {v for v in values if isinstance(v, str)}
        return np.array([v in wanted for v in column], bool)
    wanted = [float(v) for v in values
              if isinstance(v, (int, float, np.integer, np.floating)) and not isinstance(v, bool)]
    return np.isin(column, wanted)


def feature_matrix(columns: dict, names: list, keep: np.ndarray,
                   code_dtype=np.int64) -> np.ndarray:
    """float32 (rows kept, len(names)): numeric columns as they are, text
    columns as their codes over the kept rows."""
    X = np.empty((int(keep.sum()), len(names)), np.float32)
    for j, name in enumerate(names):
        col = columns[name][keep]
        X[:, j] = category_codes(col).astype(code_dtype) if is_text(col) else col
    return X


def _load(csv_path: str, start_col: int, label_col: str, classes: list[str]):
    all_cols, columns = read_table(csv_path)
    if len(all_cols) <= start_col:
        raise ValueError(
            f"CSV has fewer than {start_col + 1} columns; cannot take features from index {start_col}"
        )
    feature_cols = [c for c in all_cols[start_col:] if c != label_col]
    if label_col not in columns:
        raise ValueError(f"Missing column: {label_col}")
    labels = columns[label_col]
    keep = isin(labels, classes)
    if not keep.any():
        raise ValueError(f"No samples for classes {classes} in column '{label_col}'")
    mapping = {c: i for i, c in enumerate(classes)}
    y = np.array([mapping[v] for v in labels[keep]], np.int64)
    X = feature_matrix(columns, feature_cols, keep, np.int16)
    return X, y, feature_cols


def load_adni_data_binary(csv_path: str, start_col: int, label_col: str = "Group",
                          class0: str = "CN", class1: str = "AD"):
    X, y, _ = _load(csv_path, start_col, label_col, [class0, class1])
    return X, y


def load_adni_data_triclass(csv_path: str, start_col: int, label_col: str = "Group",
                            class0: str = "CN", class1: str = "MCI", class2: str = "AD"):
    X, y, _ = _load(csv_path, start_col, label_col, [class0, class1, class2])
    return X, y


def load_adni_data_quadclass(csv_path: str, start_col: int, label_col: str = "Group",
                             class0: str = "CN", class1: str = "SMCI",
                             class2: str = "PMCI", class3: str = "AD"):
    X, y, _ = _load(csv_path, start_col, label_col, [class0, class1, class2, class3])
    return X, y


def load_adni_table(csv_path: str, label_col: str = "Group",
                    classes: list[str] | None = None, start_col: int = 14):
    """Generalized loader used by the embedding pipeline (features from
    column 14)."""
    classes = classes or ["CN", "AD"]
    return _load(csv_path, start_col, label_col, classes)


def write_table(path: str, columns: dict) -> str:
    """Write {name: column} as pandas' ``to_csv(index=False)`` writes it:
    floats in numpy's shortest form for their dtype, missing values
    empty."""
    names = list(columns)
    cells = []
    for name in names:
        col = columns[name]
        arr = np.asarray(col)
        if arr.dtype.kind == "f":
            text = arr.astype(str)
            cells.append(np.where(np.isnan(arr), "", text).tolist())
        elif arr.dtype.kind in "iub":
            cells.append(arr.astype(str).tolist())
        else:
            cells.append(["" if v is None else str(v) for v in col])
    with open(path, "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(names)
        w.writerows(zip(*cells))
    return path
