"""SQLite run store with the reference's exact schema.

Schema parity (src/AbcSmc.cpp:819-834):

    create table job ( serial int primary key asc, smcSet int, particleIdx int,
                       startTime int, duration real, status text, posterior int,
                       attempts int );
    create index idx1 on job (status, attempts);
    create table par ( serial int primary key, seed blob, <par short names> real... );
    create table upar ( ... );      -- only when untransforms are configured
    create table met ( serial int primary key, <met short names> real... );

Concurrency parity: claims and writebacks run in BEGIN EXCLUSIVE transactions
(src/AbcSmc.cpp:887, 936) with busy-retry (the sqdb wrapper sleeps 1s on
SQLITE_BUSY, lib/sqdb/src/sqdb.cpp:271-289 - here a busy_timeout), giving the
same at-least-once multi-process worker semantics. Databases produced by the C++
reference are readable by this store and vice versa.
"""

from __future__ import annotations

import sqlite3
import time

import numpy as np

from abcsmc_tpu.errors import StorageError
from abcsmc_tpu.storage.base import ClaimedJobs, GenerationData, Storage

JOB_TABLE = "job"
PAR_TABLE = "par"
UPAR_TABLE = "upar"
MET_TABLE = "met"

#: bulk-insert window (rows). Inserts stream the numpy matrices into sqlite
#: in windows of this many rows, so the peak host overhead is O(window)
#: boxed Python floats instead of O(N) - a whole-matrix .tolist() of a
#: 100M-row [N, P] f64 matrix is tens of GB of PyFloat objects and OOMs the
#: host long before sqlite sees a row. The enclosing
#: transaction still spans ALL windows: a crash mid-insert rolls the whole
#: generation back, preserving the reference's the-DB-is-the-checkpoint
#: contract (a set is either fully present or absent,
#: /root/reference/src/AbcSmc.cpp:452-479, 819-874).
INSERT_WINDOW_ROWS = 1 << 16


def _tables_exist(conn, names) -> bool:
    cur = conn.execute(
        "select name from sqlite_master where type='table'"
    )
    have = {r[0] for r in cur.fetchall()}
    return all(n in have for n in names)


class SQLiteStorage(Storage):
    def __init__(self, path: str, busy_timeout_s: float = 60.0):
        self.path = path
        self.busy_timeout_ms = int(busy_timeout_s * 1000)
        self.par_names: list[str] = []
        self.met_names: list[str] = []
        self.has_upar = False
        #: optional provenance written into abc_meta at create()
        self.meta: dict | None = None
        #: physical table names; remapped to the historical reference names
        #: (jobs/parameters/metrics) when opening an old database
        self._job, self._par, self._met = JOB_TABLE, PAR_TABLE, MET_TABLE
        self._conn: sqlite3.Connection | None = None
        self._load_schema_if_present()

    # -- connection -------------------------------------------------------------
    def _connect(self) -> sqlite3.Connection:
        if self._conn is None:
            conn = None
            try:
                conn = sqlite3.connect(self.path, isolation_level=None)
                # busy_timeout first: the header probe below must WAIT on a
                # concurrently-locked healthy database, not fail fast
                conn.execute(f"pragma busy_timeout={self.busy_timeout_ms}")
                # force the header read NOW: sqlite connects lazily, so a
                # corrupt / non-database file would otherwise surface as a
                # raw sqlite3.DatabaseError from whichever query runs first
                # (the sqdb wrapper's open-time Exception is the reference
                # analog, lib/sqdb/src/sqdb.cpp)
                conn.execute("pragma schema_version").fetchone()
            except sqlite3.Error as e:
                if conn is not None:
                    conn.close()  # a retrying caller must not leak the fd
                raise StorageError(
                    f"cannot open database {self.path!r}: {e}", code=1
                ) from e
            self._conn = conn
        return self._conn

    def close(self):
        if self._conn is not None:
            self._conn.close()
            self._conn = None

    def _load_schema_if_present(self):
        conn = self._connect()
        if _tables_exist(conn, [JOB_TABLE, PAR_TABLE, MET_TABLE]):
            self._job, self._par, self._met = JOB_TABLE, PAR_TABLE, MET_TABLE
        elif _tables_exist(conn, ["jobs", "parameters", "metrics"]):
            # historical reference schema (pre-rename; see
            # examples/scratch/posterior.sqlite and vis/abc_plots.R:5 in the
            # reference): same columns, old table names - readable here so
            # old posterior databases keep working as POSTERIOR sources
            self._job, self._par, self._met = "jobs", "parameters", "metrics"
        else:
            return
        par_cols = [r[1] for r in conn.execute(f"pragma table_info({self._par})")]
        met_cols = [r[1] for r in conn.execute(f"pragma table_info({self._met})")]
        self.par_names = par_cols[2:]  # skip serial, seed
        self.met_names = met_cols[1:]  # skip serial
        self.has_upar = _tables_exist(conn, [UPAR_TABLE])

    # -- lifecycle -------------------------------------------------------------
    def exists(self) -> bool:
        conn = self._connect()
        return _tables_exist(conn, [JOB_TABLE, PAR_TABLE, MET_TABLE]) or (
            _tables_exist(conn, ["jobs", "parameters", "metrics"])
        )

    def is_empty(self) -> bool:
        if not self.exists():
            return True
        if not self.par_names:
            # tables appeared after this object's construction (another
            # process created them); resolve names before any repair insert
            self._load_schema_if_present()
        conn = self._connect()
        return conn.execute(
            f"select exists(select 1 from {self._job})"
        ).fetchone()[0] == 0

    def create(self, par_names, met_names, has_upar):
        self._job, self._par, self._met = JOB_TABLE, PAR_TABLE, MET_TABLE
        self.par_names = list(par_names)
        self.met_names = list(met_names)
        self.has_upar = has_upar
        conn = self._connect()
        par_cols = ", ".join(f"{n} real" for n in par_names)
        met_cols = ", ".join(f"{n} real" for n in met_names)
        conn.execute("BEGIN EXCLUSIVE")
        try:
            conn.execute(
                f"create table {JOB_TABLE} ( serial int primary key asc, "
                f"smcSet int, particleIdx int, startTime int, duration real, "
                f"status text, posterior int, attempts int )"
            )
            conn.execute(
                f"create index idx1 on {JOB_TABLE} (status, attempts)"
            )
            conn.execute(
                f"create table {PAR_TABLE} ( serial int primary key, seed blob, "
                f"{par_cols} )"
            )
            if has_upar:
                conn.execute(
                    f"create table {UPAR_TABLE} ( serial int primary key, "
                    f"seed blob, {par_cols} )"
                )
            conn.execute(
                f"create table {MET_TABLE} ( serial int primary key, {met_cols} )"
            )
            # additive extension over the reference schema: run provenance
            # (config, framework version, creation time); the reference
            # tables and any tooling reading them are unaffected
            conn.execute(
                "create table if not exists abc_meta ( key text primary key, "
                "value text )"
            )
            for k, v in (self.meta or {}).items():
                conn.execute(
                    "insert or replace into abc_meta values ( ?, ? )",
                    (str(k), str(v)),
                )
            conn.execute("COMMIT")
        except Exception:
            conn.execute("ROLLBACK")
            raise

    def insert_generation(
        self, set_num, params, seeds, upars=None, posterior_ranks=None,
        if_empty=False, window: int = INSERT_WINDOW_ROWS,
    ):
        params = np.asarray(params, np.float64)
        n = params.shape[0]
        seeds = np.asarray(seeds)
        upars = (
            np.asarray(upars, np.float64)
            if (self.has_upar and upars is not None) else None
        )
        conn = self._connect()
        conn.execute("BEGIN EXCLUSIVE")
        try:
            row = conn.execute(
                f"select coalesce(max(serial), -1) from {self._job}"
            ).fetchone()
            start = int(row[0]) + 1
            if if_empty and start != 0:
                # rows appeared between the caller's emptiness check and
                # this EXCLUSIVE transaction (another worker repaired the
                # crash window first); abort without inserting
                conn.execute("ROLLBACK")
                return None
            self._stream_insert_windows(
                conn, start, set_num, params, seeds, upars,
                posterior_ranks, None, "NULL, 'Q', ?, 0", window,
            )
            conn.execute("COMMIT")
        except Exception:
            conn.execute("ROLLBACK")
            raise
        return np.arange(start, start + n, dtype=np.int64)

    def insert_generation_complete(
        self, set_num, params, seeds, metrics, upars=None,
        posterior_ranks=None, window: int = INSERT_WINDOW_ROWS,
    ):
        """Single-pass bulk insert of a finished generation: job rows land
        'D' and met rows land with values, skipping the per-row guarded
        writeback (2.5x faster at 1M rows; correct because the rows are brand
        new - no other worker can hold claims on them).

        Rows stream into sqlite in ``window``-row blocks inside ONE
        enclosing transaction (see INSERT_WINDOW_ROWS): the device path
        mirrors populations far beyond what a whole-matrix ``.tolist()``
        survives in host RAM (measured: 10M rows x (2 par + 2 met) mirror
        in docs/SCALING.md 'The durable-store bill'), while a crash at any
        point still rolls the whole set back - set-level atomicity is what
        resume correctness keys on (engine reads only COMPLETE sets,
        /root/reference/src/AbcSmc.cpp:571-592)."""
        params = np.asarray(params, np.float64)
        metrics = np.asarray(metrics, np.float64)
        seeds = np.asarray(seeds)
        upars = (
            np.asarray(upars, np.float64)
            if (self.has_upar and upars is not None) else None
        )
        ranks = (
            np.asarray(posterior_ranks)
            if posterior_ranks is not None else None
        )
        n = params.shape[0]
        conn = self._connect()
        conn.execute("BEGIN EXCLUSIVE")
        try:
            row = conn.execute(
                f"select coalesce(max(serial), -1) from {self._job}"
            ).fetchone()
            start = int(row[0]) + 1
            self._stream_insert_windows(
                conn, start, set_num, params, seeds, upars,
                ranks, metrics, "0.0, 'D', ?, 1", window,
            )
            conn.execute("COMMIT")
        except Exception:
            conn.execute("ROLLBACK")
            raise
        return np.arange(start, start + n, dtype=np.int64)

    def _stream_insert_windows(
        self, conn, start, set_num, params, seeds, upars, ranks, metrics,
        job_tail_sql, window,
    ):
        """Shared windowed bulk-insert loop (see INSERT_WINDOW_ROWS): one
        window's Python rows are boxed at a time, all inside the CALLER's
        enclosing transaction. ``job_tail_sql`` fills the job row's
        (duration, status, posterior, attempts) columns; ``metrics`` None
        writes NULL met rows (queued jobs), an [N, M] matrix writes values
        (finished generations)."""
        n = params.shape[0]
        now = int(time.time())
        par_ph = ", ".join(["?"] * len(self.par_names))
        met_ph = ", ".join(
            ["?" if metrics is not None else "NULL"] * len(self.met_names)
        )
        for w0 in range(0, n, window):
            w1 = min(w0 + window, n)
            # seed stored as a text blob, matching the reference's quoted
            # insert (src/AbcSmc.cpp:537, 859-860)
            seeds_w = [str(int(s)) for s in seeds[w0:w1]]
            conn.executemany(
                f"insert into {self._job} values "
                f"( ?, ?, ?, ?, {job_tail_sql} )",
                (
                    (start + i, int(set_num), i, now,
                     int(ranks[i]) if ranks is not None else -1)
                    for i in range(w0, w1)
                ),
            )
            pw = params[w0:w1].tolist()
            conn.executemany(
                f"insert into {self._par} values ( ?, ?, {par_ph} )",
                (
                    (start + w0 + j, seeds_w[j], *pw[j])
                    for j in range(w1 - w0)
                ),
            )
            if upars is not None:
                uw = upars[w0:w1].tolist()
                conn.executemany(
                    f"insert into {UPAR_TABLE} values ( ?, ?, {par_ph} )",
                    (
                        (start + w0 + j, seeds_w[j], *uw[j])
                        for j in range(w1 - w0)
                    ),
                )
            if metrics is None:
                conn.executemany(
                    f"insert into {self._met} values ( ?, {met_ph} )",
                    ((start + i,) for i in range(w0, w1)),
                )
            else:
                mw = metrics[w0:w1].tolist()
                conn.executemany(
                    f"insert into {self._met} values ( ?, {met_ph} )",
                    ((start + w0 + j, *mw[j]) for j in range(w1 - w0)),
                )

    # -- reads -----------------------------------------------------------------
    def read_generations(self):
        conn = self._connect()
        if not self.exists():
            raise StorageError(
                "Failed to read SMC set from database because one or more "
                "tables are missing."
            )
        if not self.par_names:
            # tables appeared after this object's construction (another
            # process of a multi-process mesh created them); resolve the
            # column names before building the SELECT
            self._load_schema_if_present()
        par_sel = ", ".join(f"P.{n}" for n in self.par_names)
        met_sel = ", ".join(f"M.{n}" for n in self.met_names)
        sets = [
            r[0]
            for r in conn.execute(
                f"select distinct smcSet from {self._job} order by smcSet"
            )
        ]
        out = []
        for t in sets:
            rows = conn.execute(
                f"select J.serial, J.particleIdx, J.posterior, J.status, P.seed, "
                f"{par_sel}, {met_sel} "
                f"from {self._job} J, {self._met} M, {self._par} P "
                f"where J.serial = M.serial and J.serial = P.serial "
                f"and J.smcSet = ? order by J.particleIdx",
                (int(t),),
            ).fetchall()
            npar = len(self.par_names)
            nmet = len(self.met_names)
            serials = np.array([r[0] for r in rows], np.int64)
            posterior = np.array([r[2] for r in rows], np.int64)
            statuses = np.array([r[3] for r in rows])
            seeds = np.array([int(r[4]) for r in rows], np.uint64)
            params = np.array(
                [[_f(v) for v in r[5 : 5 + npar]] for r in rows], np.float64
            ).reshape(len(rows), npar)
            metrics = np.array(
                [[_f(v) for v in r[5 + npar : 5 + npar + nmet]] for r in rows],
                np.float64,
            ).reshape(len(rows), nmet)
            out.append(
                GenerationData(
                    set_num=int(t), serials=serials, params=params,
                    metrics=metrics, posterior_ranks=posterior,
                    statuses=statuses, seeds=seeds,
                )
            )
        return out

    def write_posterior_ranks(self, serials, ranks):
        conn = self._connect()
        conn.execute("BEGIN EXCLUSIVE")
        try:
            conn.executemany(
                f"update {self._job} set posterior = ? where serial = ?",
                [(int(r), int(s)) for s, r in zip(serials, ranks)],
            )
            conn.execute("COMMIT")
        except Exception:
            conn.execute("ROLLBACK")
            raise

    # -- job queue ----------------------------------------------------------------
    def claim_jobs(self, n=1, serial_req=-1, posterior_req=-1):
        conn = self._connect()
        if not self.par_names:
            # the handle may predate the tables (a worker starting before
            # the builder's --process on a shared DB): re-resolve the
            # schema now, or the par_sel below is permanently empty SQL
            self._load_schema_if_present()
        table = UPAR_TABLE if self.has_upar else self._par
        par_sel = ", ".join(f"P.{nm}" for nm in self.par_names)
        base = (
            f"select J.serial, P.seed, {par_sel} from {table} P, {self._job} J "
            f"where P.serial = J.serial "
        )
        if serial_req > -1:
            q = base + f"and J.serial = {int(serial_req)}"
        elif posterior_req > -1:
            q = base + (
                f"and smcSet = (select max(smcSet) from {self._job} "
                f"where posterior > -1) and posterior = {int(posterior_req)}"
            )
        else:
            limit = "" if n == -1 else f"limit {int(n)}"
            q = base + (
                f"and (J.status = 'Q' or J.status = 'R') "
                f"order by J.status, J.attempts {limit}"
            )
        now = int(time.time())
        conn.execute("BEGIN EXCLUSIVE")
        try:
            rows = conn.execute(q).fetchall()
            conn.executemany(
                f"update {self._job} set startTime = {now}, status = 'R', "
                f"attempts = attempts + 1 where serial = ?",
                [(int(r[0]),) for r in rows],
            )
            conn.execute("COMMIT")
        except Exception:
            conn.execute("ROLLBACK")
            raise
        npar = len(self.par_names)
        return ClaimedJobs(
            serials=np.array([r[0] for r in rows], np.int64),
            seeds=np.array([int(r[1]) for r in rows], np.uint64),
            params=np.array(
                [[_f(v) for v in r[2 : 2 + npar]] for r in rows], np.float64
            ).reshape(len(rows), npar),
        )

    def read_runnable(self):
        """Read-only claim view: see Storage.read_runnable."""
        conn = self._connect()
        if not self.par_names:
            self._load_schema_if_present()
        table = UPAR_TABLE if self.has_upar else self._par
        par_sel = ", ".join(f"P.{nm}" for nm in self.par_names)
        rows = conn.execute(
            f"select J.serial, P.seed, {par_sel} from {table} P, "
            f"{self._job} J where P.serial = J.serial "
            f"and (J.status = 'Q' or J.status = 'R') order by J.serial"
        ).fetchall()
        npar = len(self.par_names)
        return ClaimedJobs(
            serials=np.array([r[0] for r in rows], np.int64),
            seeds=np.array([int(r[1]) for r in rows], np.uint64),
            params=np.array(
                [[_f(v) for v in r[2 : 2 + npar]] for r in rows], np.float64
            ).reshape(len(rows), npar),
        )

    def write_results(self, serials, metrics, start_times, durations):
        conn = self._connect()
        if not self.met_names:
            # same late-schema guard as claim_jobs: a pre-tables handle
            # would render 'update met set  where ...' forever
            self._load_schema_if_present()
        met_set = ", ".join(f"{nm} = ?" for nm in self.met_names)
        written = 0
        conn.execute("BEGIN EXCLUSIVE")
        try:
            for s, met, st, dur in zip(serials, metrics, start_times, durations):
                s = int(s)
                conn.execute(
                    f"update {self._met} set {met_set} where serial = ? and "
                    f"(select (status = 'R' or status = 'Q' or status = 'P') "
                    f"from {self._job} J where J.serial = ?)",
                    (*[float(v) for v in met], s, s),
                )
                cur = conn.execute(
                    f"update {self._job} set startTime = ?, duration = ?, "
                    f"status = 'D' where serial = ? and "
                    f"(status = 'R' or status = 'Q' or status = 'P')",
                    (int(st), float(dur), s),
                )
                written += cur.rowcount
            conn.execute("COMMIT")
        except Exception:
            conn.execute("ROLLBACK")
            raise
        return written

    # -- posterior slurp (for POSTERIOR parameters) ---------------------------------
    def read_posterior_matrix(self, short_names: list[str]) -> np.ndarray:
        """slurp_posterior parity (src/AbcSmc.cpp:293-335): values of the named
        columns for rows with posterior > -1, in *serial* order (the reference
        does not order by rank - preserved quirk)."""
        conn = self._connect()
        table = UPAR_TABLE if _tables_exist(conn, [UPAR_TABLE]) else self._par
        cols = ", ".join(short_names)
        rows = conn.execute(
            f"select {cols} from {table} P, {self._job} J "
            f"where P.serial = J.serial and posterior > -1"
        ).fetchall()
        return np.array(
            [[_f(v) for v in r] for r in rows], np.float64
        ).reshape(len(rows), len(short_names))


def _f(v) -> float:
    return float("nan") if v is None else float(v)


def create_legacy_views(db_path: str):
    """Create views with the OLD reference table names (jobs / parameters /
    metrics) over the current schema, so the reference's historical analysis
    scripts (vis/abc_plots.R reads `jobs`, SURVEY parity-landmines section)
    run against databases produced here."""
    conn = sqlite3.connect(db_path)
    try:
        for view, table in (
            ("jobs", JOB_TABLE), ("parameters", PAR_TABLE),
            ("metrics", MET_TABLE),
        ):
            conn.execute(
                f"create view if not exists {view} as select * from {table}"
            )
        conn.commit()
    finally:
        conn.close()
