"""Full type/enum demo (reference examples/types): one table exercising
every fixed-width type family + strings + wide ints + decimals.

    JAX_PLATFORMS=cpu python examples/types_demo.py
"""

import sys

import numpy as np

sys.path.insert(0, ".")
import knoxdb_tpu.knox as knox
from knoxdb_tpu.schema.schema import Builder
from knoxdb_tpu.types import FieldType


def main():
    db = knox.create_database("types", background_merge=False)
    sch = (Builder("alltypes").pk("id")
           .add("i8", FieldType.INT8).add("u16", FieldType.UINT16)
           .add("i32", FieldType.INT32).add("u64", FieldType.UINT64)
           .add("f32", FieldType.FLOAT32).add("f64", FieldType.FLOAT64)
           .add("ts", FieldType.TIMESTAMP)
           .add("s", FieldType.STRING).add("raw", FieldType.BYTES)
           .add("big", FieldType.INT128)
           .add("dec", FieldType.DECIMAL64, scale=4)
           .finish())
    t = db.create_table(sch)
    n = 100
    rng = np.random.default_rng(0)
    t.insert({
        "id": np.zeros(n, np.uint64),
        "i8": rng.integers(-128, 128, n).astype(np.int8),
        "u16": rng.integers(0, 1 << 16, n).astype(np.uint16),
        "i32": rng.integers(-(1 << 31), 1 << 31, n).astype(np.int32),
        "u64": rng.integers(0, 1 << 63, n).astype(np.uint64),
        "f32": rng.normal(size=n).astype(np.float32),
        "f64": rng.integers(-10**6, 10**6, n) / 100.0,    # ALP-compressible
        "ts": rng.integers(0, 10**18, n),
        "s": [f"name-{i % 7}" for i in range(n)],
        "raw": [bytes([i % 256, 255 - i % 256]) for i in range(n)],
        "big": [int(x) * 10**25 for x in rng.integers(-100, 100, n)],
        "dec": rng.integers(-10**8, 10**8, n),
    })
    t.merge()
    print("rows:", t.count())
    print("schemes:",
          {f: {p.scheme.name for p in c.packs}
           for f, c in t._t.segments[0].seg.columns.items()
           if not f.startswith("$")})
    print("i8 < 0:", t.query().where(knox.F("i8") < 0).count())
    print("s == name-3:", t.query().where(knox.F("s") == "name-3").count())
    print("f64 sum (exact):", t.query().sum("f64"))
    print("big max:", t.query().max("big"))
    print("dec avg:", t.query().avg("dec"))
    db.close()


if __name__ == "__main__":
    main()
