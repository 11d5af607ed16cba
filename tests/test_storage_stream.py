"""Streaming bulk inserts: windowed row blocks must land the identical
database as a one-shot insert (the whole-matrix
.tolist() path OOMed the host long before sqlite at device-scale N; see
storage/sqlite_store.py::INSERT_WINDOW_ROWS and docs/SCALING.md 'The
durable-store bill')."""

import sqlite3

import numpy as np

from abcsmc_tpu.storage import SQLiteStorage


def _mkstore(path, upar=True):
    st = SQLiteStorage(str(path))
    st.create(["p1", "p2", "p3"], ["m1", "m2"], upar)
    return st


def _dump(path, skip_start_time=True):
    conn = sqlite3.connect(str(path))
    # startTime is wall-clock at insert; everything else must be identical
    job = conn.execute(
        "select serial, smcSet, particleIdx, duration, status, posterior, "
        "attempts from job order by serial"
    ).fetchall()
    par = conn.execute("select * from par order by serial").fetchall()
    upar = conn.execute("select * from upar order by serial").fetchall()
    met = conn.execute("select * from met order by serial").fetchall()
    conn.close()
    return job, par, upar, met


def test_windowed_inserts_match_one_shot(tmp_path):
    rng = np.random.default_rng(5)
    n = 1000
    params = rng.normal(size=(n, 3))
    upars = params * 2.0
    mets = rng.normal(size=(n, 2))
    seeds = rng.integers(0, 2**31, size=n).astype(np.uint64)
    ranks = np.full(n, -1, np.int64)
    ranks[rng.choice(n, 100, replace=False)] = np.arange(100)

    a = _mkstore(tmp_path / "oneshot.sqlite")
    b = _mkstore(tmp_path / "windowed.sqlite")
    # window=7 forces ~143 partial blocks incl. a ragged tail; window >= n
    # is the old one-shot behavior
    sa = a.insert_generation_complete(0, params, seeds, mets, upars, ranks,
                                      window=1 << 30)
    sb = b.insert_generation_complete(0, params, seeds, mets, upars, ranks,
                                      window=7)
    np.testing.assert_array_equal(sa, sb)

    # second set through the 'Q' enqueue path (window vs one-shot)
    a.insert_generation(1, params[:500], seeds[:500], upars[:500],
                        window=1 << 30)
    b.insert_generation(1, params[:500], seeds[:500], upars[:500], window=7)

    da, db = _dump(tmp_path / "oneshot.sqlite"), _dump(
        tmp_path / "windowed.sqlite"
    )
    assert da == db
    # sanity on content, not just equality
    job, par, upar, met = db
    assert len(job) == 1500 and len(par) == 1500 and len(met) == 1500
    assert [r[4] for r in job[:1000]] == ["D"] * 1000
    assert [r[4] for r in job[1000:]] == ["Q"] * 500
    assert sum(r[5] > -1 for r in job) == 100


def test_windowed_insert_atomic_on_failure(tmp_path):
    """A failure inside a later window must roll back EVERY window - the
    set-level atomicity resume correctness keys on."""
    st = _mkstore(tmp_path / "atomic.sqlite", upar=False)
    n = 50
    params = np.zeros((n, 3))
    mets = np.zeros((n, 2))
    seeds = np.arange(n, dtype=np.uint64)
    # a rank that cannot int() poisons window 3 (rows 30-39) AFTER windows
    # 0-2 already executed their inserts
    ranks = [-1] * n
    ranks[37] = "boom"
    try:
        st.insert_generation_complete(
            0, params, seeds, mets, posterior_ranks=ranks, window=10
        )
    except ValueError:
        pass
    else:  # pragma: no cover
        raise AssertionError("expected the poisoned rank to fail")
    conn = sqlite3.connect(str(tmp_path / "atomic.sqlite"))
    counts = [
        conn.execute(f"select count(*) from {t}").fetchone()[0]
        for t in ("job", "par", "met")
    ]
    conn.close()
    assert counts == [0, 0, 0], counts
