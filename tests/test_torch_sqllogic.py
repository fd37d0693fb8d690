"""Port parity: the sqllogictest runner (duckdb_vss_tpu_torch.sql.sqllogic)
against the JAX package's, on inline scripts written to tmp_path.

The reference's own .test files are not in this repository (the JAX
package's tests/test_sqllogic.py skips without them); these scripts use
the same directives: require, load / restart (a disk database and its
reopen), statement ok / error with the expected message, query with
expected rows (rowsort, labels, <REGEX>: cells, numeric tolerance) and
loop / endloop. Each runs through both runners, which must reach the
same verdict: the same number of checked queries, or a SqlLogicFailure
/ SkipFile with the same message.
"""

import textwrap

import pytest
import torch

from duckdb_vss_tpu.sql import sqllogic as jlogic
from duckdb_vss_tpu_torch.sql import sqllogic as tlogic

torch.set_num_threads(2)

SCRIPTS = {
    "basic_pass": """
        require vss

        statement ok
        CREATE TABLE t1 (vec FLOAT[3]);

        statement ok
        INSERT INTO t1 SELECT array_value(a,b,c) FROM range(1,6) ra(a),
            range(1,6) rb(b), range(1,6) rc(c);

        statement ok
        CREATE INDEX my_idx ON t1 USING HNSW (vec);

        query I
        EXPLAIN SELECT * FROM t1 ORDER BY array_distance(vec,
            [1,2,3]::FLOAT[3]) LIMIT 3;
        ----
        physical_plan	<REGEX>:.*HNSW_INDEX_SCAN.*

        query I
        SELECT array_distance([1,2,3]::FLOAT[3], vec) < 1.5 FROM t1
            ORDER BY array_distance(vec, [1,2,3]::FLOAT[3]) LIMIT 3;
        ----
        true
        true
        true

        statement error
        CREATE INDEX bad ON t1 USING HNSW (vec) WITH (metric='nonexist');
        ----
        Binder Error: Unknown metric kind: 'nonexist'

        statement error
        CREATE INDEX bad ON t1 USING HNSW (vec) WITH (m=1);
        ----
        Binder Error: HNSW index 'M' must be at least 2

        query I rowsort
        SELECT vec FROM t1 ORDER BY array_distance(vec, [5,5,5]::FLOAT[3])
            LIMIT 1;
        ----
        [5.0, 5.0, 5.0]
        """,
    "loop_labels_and_pragmas": """
        statement ok
        CREATE TABLE t (id INT, vec FLOAT[2]);

        loop i 0 12

        statement ok
        INSERT INTO t VALUES (${i}, [${i}, ${i}]);

        endloop

        statement ok
        CREATE INDEX idx ON t USING HNSW (vec);

        query II nosort indexed
        SELECT id, array_distance(vec, [3.2, 3.2]::FLOAT[2]) AS d FROM t
            ORDER BY array_distance(vec, [3.2, 3.2]::FLOAT[2]) LIMIT 2;
        ----
        3	0.282843
        4	1.13137

        statement ok
        PRAGMA disable_optimizer;

        query II nosort indexed
        SELECT id, array_distance(vec, [3.2, 3.2]::FLOAT[2]) AS d FROM t
            ORDER BY array_distance(vec, [3.2, 3.2]::FLOAT[2]) LIMIT 2;
        ----

        statement ok
        PRAGMA enable_optimizer;

        statement ok
        DELETE FROM t WHERE id < 5;

        statement ok
        PRAGMA hnsw_compact_index('idx');

        query I
        SELECT count FROM pragma_hnsw_index_info();
        ----
        7

        query I
        SELECT list_sum(flatten(min_by(vec, array_distance(vec,
            [0,0]::FLOAT[2]), 2))) FROM t;
        ----
        22.0
        """,
    "restart": """
        load __TEST_DIR__/db

        statement ok
        SET hnsw_enable_experimental_persistence = true;

        statement ok
        CREATE TABLE t (id INT, vec FLOAT[3]);

        statement ok
        INSERT INTO t VALUES (1, [1,2,3]), (2, [4,5,6]), (3, [7,8,9]);

        statement ok
        CREATE INDEX idx ON t USING HNSW (vec);

        statement ok
        CHECKPOINT;

        statement ok
        INSERT INTO t VALUES (4, [9,9,9]);

        restart

        query I
        SELECT id FROM t ORDER BY array_distance(vec, [9,9,9]::FLOAT[3])
            LIMIT 2;
        ----
        4
        3

        query I
        EXPLAIN SELECT id FROM t ORDER BY array_distance(vec,
            [9,9,9]::FLOAT[3]) LIMIT 2;
        ----
        physical_plan	<REGEX>:.*HNSW_INDEX_SCAN.*
        """,
    "wrong_rows": """
        statement ok
        CREATE TABLE t (id INT, vec FLOAT[2]);

        statement ok
        INSERT INTO t VALUES (1, [0,0]), (2, [5,5]);

        query I
        SELECT id FROM t ORDER BY array_distance(vec, [4,4]::FLOAT[2])
            LIMIT 1;
        ----
        1
        """,
    "wrong_error_text": """
        statement error
        CREATE INDEX i ON nope USING HNSW (vec) WITH (ef_search=0);
        ----
        Binder Error: something else
        """,
    "unexpected_success": """
        statement ok
        CREATE TABLE t (vec FLOAT[2]);

        statement error
        INSERT INTO t VALUES ([1,2]);
        """,
    "unsupported_require": """
        require parquet

        statement ok
        CREATE TABLE t (vec FLOAT[2]);
        """,
}


def _verdict(mod, path, test_dir, **kw):
    try:
        return ("ok", mod.run_sqllogic_file(str(path), str(test_dir), **kw))
    except mod.SkipFile as why:
        return ("skip", str(why))
    except mod.SqlLogicFailure as err:
        return ("fail", str(err))


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_same_verdict(name, tmp_path):
    path = tmp_path / f"{name}.test"
    path.write_text(textwrap.dedent(SCRIPTS[name]))
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    want = _verdict(jlogic, path, tmp_path / "jax")
    got = _verdict(tlogic, path, tmp_path / "port", device="cpu")
    assert got == want
    expected = {"wrong_rows": "fail", "wrong_error_text": "fail",
                "unexpected_success": "fail", "unsupported_require": "skip"}
    assert got[0] == expected.get(name, "ok"), got


def test_runner_database_lives_on_the_device(tmp_path):
    runner = tlogic.SqlLogicRunner(str(tmp_path), device="cpu")
    assert runner.db.device == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tlogic.SqlLogicRunner(str(tmp_path))
