"""Benchmark-database visitors (copy of ``lp_mp_tpu/visitors_db.py``).

Counterpart of ``sqlite_visitor.hxx`` / ``postgresql_visitor.hxx``: persist
one row per iteration {iteration, time ms, lower bound, upper bound} keyed
by (solver, dataset, instance) for benchmark aggregation
(sqlite_visitor.hxx:14-19, schema :29-60), plus a CSV/JSONL logger for
lightweight runs.  The schema is the JAX package's, so both packages' rows
can share one database, told apart by ``solver_name``.
"""
from __future__ import annotations

import dataclasses
import json
import sqlite3

from .visitors import StandardTighteningVisitor

_SCHEMA = """
CREATE TABLE IF NOT EXISTS solvers (
  id INTEGER PRIMARY KEY AUTOINCREMENT, name TEXT UNIQUE NOT NULL);
CREATE TABLE IF NOT EXISTS datasets (
  id INTEGER PRIMARY KEY AUTOINCREMENT, name TEXT UNIQUE NOT NULL);
CREATE TABLE IF NOT EXISTS instances (
  id INTEGER PRIMARY KEY AUTOINCREMENT, name TEXT NOT NULL,
  dataset_id INTEGER NOT NULL REFERENCES datasets(id),
  UNIQUE(name, dataset_id));
CREATE TABLE IF NOT EXISTS iterations (
  solver_id INTEGER NOT NULL REFERENCES solvers(id),
  instance_id INTEGER NOT NULL REFERENCES instances(id),
  iteration INTEGER NOT NULL, timeMS REAL,
  lowerBound REAL, upperBound REAL,
  PRIMARY KEY(solver_id, instance_id, iteration));
"""


@dataclasses.dataclass
class SqliteVisitor(StandardTighteningVisitor):
    """Writes per-iteration rows to an sqlite benchmark DB
    (sqlite_visitor.hxx semantics; stdlib sqlite3)."""

    db_path: str = "benchmark.db"
    solver_name: str = "lp_mp_tpu_torch"
    dataset_name: str = "default"
    instance_name: str = "instance"

    def __post_init__(self):
        super().__post_init__()
        self._conn = sqlite3.connect(self.db_path)
        self._conn.executescript(_SCHEMA)
        self._solver_id = self._get_id("solvers", self.solver_name)
        ds = self._get_id("datasets", self.dataset_name)
        cur = self._conn.execute(
            "INSERT OR IGNORE INTO instances(name, dataset_id) VALUES (?, ?)",
            (self.instance_name, ds))
        self._conn.commit()
        self._instance_id = self._conn.execute(
            "SELECT id FROM instances WHERE name=? AND dataset_id=?",
            (self.instance_name, ds)).fetchone()[0]
        prev_log = self.log_fn

        def log(rec):
            self._conn.execute(
                "INSERT OR REPLACE INTO iterations VALUES (?, ?, ?, ?, ?, ?)",
                (self._solver_id, self._instance_id, rec["iteration"],
                 rec["time_ms"], rec["lower_bound"], rec["upper_bound"]))
            self._conn.commit()
            if prev_log is not None:
                prev_log(rec)

        self.log_fn = log

    def close(self) -> None:
        self._conn.close()

    def _get_id(self, table: str, name: str) -> int:
        self._conn.execute(
            f"INSERT OR IGNORE INTO {table}(name) VALUES (?)", (name,))
        self._conn.commit()
        return self._conn.execute(
            f"SELECT id FROM {table} WHERE name=?", (name,)).fetchone()[0]


@dataclasses.dataclass
class JsonlVisitor(StandardTighteningVisitor):
    """One JSON object per iteration to a file (lightweight metrics
    stream; the tikz/ascii-plot visitors' data source equivalent)."""

    jsonl_path: str = "metrics.jsonl"

    def __post_init__(self):
        super().__post_init__()
        self._fh = open(self.jsonl_path, "a")
        prev_log = self.log_fn

        def log(rec):
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()
            if prev_log is not None:
                prev_log(rec)

        self.log_fn = log

    def close(self) -> None:
        self._fh.close()
