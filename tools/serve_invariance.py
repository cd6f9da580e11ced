#!/usr/bin/env python3
"""Which stages of the serve pipeline keep their bits under the lattice's
padding and batching on this device: the evidence that the card serves
the reference's lattice of ``repro_torch.serve.bucketing`` as it stands.

    PYTHONPATH=src python3 tools/serve_invariance.py [--device cpu] [--out PATH]

For each bucket shape below (the smoke lattice's and ``chip_smoke.py``
phase ``serve``'s), it draws a batch of ragged requests inside the band
(``m`` between the band below and the capacity, ``r`` from 1 to the
capacity; entry 0 at the capacity itself), pads them as the server does,
and compares, entry by entry and bitwise, each stage at the bucket's
padded shape with the same stage at the request's own shape (the twin's):

* ``gram``     — the ``syrk`` gram of the padded rows (``ata``, one leaf);
* ``factor``   — the batched Cholesky walk on the bucket's grams against
                 the twin's walk; ``factor_per_entry`` the walk run on one
                 entry of the bucket's gram;
* ``rhs``      — ``Aᵀb`` (``core.strassen._dot_tn``) batched and padded;
                 ``rhs_m`` padded in rows only, ``rhs_r`` in columns only,
                 ``rhs_batch`` one entry of the batched product against the
                 same entry alone;
* ``subst_r``  — the substitutions against the twin's factor with the
                 right-hand side padded in columns;
* ``x``        — the batched pipeline's solution against the twin's.

It prints one JSON line per bucket and, with ``--out``, writes them all.
Runs on the card unless ``--device cpu`` is given (about a minute with the
kernels' build). On the card every stage must keep its bits: the script
exits 1 if any differs (on the CPU MKL's products need not, and it
reports them).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import numpy as np
import torch

# (op, m capacity, n, r capacity, batch, smallest m of the band)
SHAPES = [("lstsq", 48, 32, 4, 4, 33), ("lstsq", 96, 32, 8, 4, 49), ("lstsq", 96, 64, 8, 4, 64),
          ("whiten", 48, 32, 4, 4, 33),
          ("lstsq", 512, 256, 8, 8, 256), ("lstsq", 512, 256, 64, 8, 256),
          ("lstsq", 8192, 256, 8, 8, 513), ("lstsq", 8192, 512, 64, 8, 513),
          ("whiten", 4096, 1024, 64, 4, 1024)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="tools/serve_invariance.py")
    ap.add_argument("--device", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from repro_torch import tune
    from repro_torch.backend import resolve_device
    from repro_torch.core.ata import ata, ata_batched
    from repro_torch.core.strassen import _dot_tn
    from repro_torch.core.symmetric import SymmetricMatrix
    from repro_torch.serve.engine import per_slice_trsm
    from repro_torch.solve.cholesky import cholesky
    from repro_torch.solve.lstsq import lstsq
    from repro_torch.solve.triangular import solve_cholesky, solve_triangular

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        print(torch.cuda.get_device_name(0), torch.__version__, torch.version.cuda, flush=True)
    eq = torch.equal
    rng = np.random.default_rng(0)
    rows_out = []
    for op, M, N, R, B, mlo in SHAPES:
        sp = dataclasses.replace(
            tune.plan(op="solve", m=M, n=N, k=R, out="packed", backend=dev.type),
            method="factor", predicted_s=None)
        ata_plan = dataclasses.replace(sp, op="ata", k=N, out="packed", method=None,
                                       predicted_s=None)
        reqs = []
        for i in range(B):
            m = M if i == 0 else int(rng.integers(mlo, M + 1))
            r = R if i == 0 else int(rng.integers(1, R + 1))
            a = rng.standard_normal((m, N)).astype(np.float32)
            b = rng.standard_normal((m if op == "lstsq" else N, r)).astype(np.float32)
            reqs.append((a, b, (0.0, 1e-3, 1e-2)[i % 3]))
        A = np.zeros((B, M, N), np.float32)
        Bm = np.zeros((B, M if op == "lstsq" else N, R), np.float32)
        for i, (a, b, _) in enumerate(reqs):
            A[i, :a.shape[0]] = a
            Bm[i, :b.shape[0], :b.shape[1]] = b
        At, Bt = torch.as_tensor(A, device=dev), torch.as_tensor(Bm, device=dev)
        ridge = torch.tensor([q[2] for q in reqs], device=dev)
        gram = ata_batched(At, plan=dataclasses.replace(ata_plan, batch=B), out="packed",
                           packed_block=sp.packed_block)
        gram = gram.add_scaled_identity(ridge.reshape(-1, 1, 1, 1))
        f = cholesky(gram, plan=sp)
        if op == "lstsq":
            rhs = _dot_tn(At, Bt, torch.float32)
            x = solve_cholesky(f, rhs, plan=sp, base_trsm=per_slice_trsm)
        else:
            x = solve_triangular(f, Bt, transpose=False, plan=sp, base_trsm=per_slice_trsm)
        entries = []
        for i, (a, b, rd) in enumerate(reqs):
            m, r = a.shape[0], b.shape[1]
            twin = dataclasses.replace(sp, m=m, k=r)
            ta, tb = torch.as_tensor(a, device=dev), torch.as_tensor(b, device=dev)
            tg = ata(ta, plan=dataclasses.replace(ata_plan, m=m), out="packed",
                     packed_block=sp.packed_block)
            tg = tg.add_scaled_identity(rd) if rd or op == "whiten" else tg
            tf = cholesky(tg, plan=twin)
            one = cholesky(SymmetricMatrix(gram.blocks[i], gram.n, gram.bn), plan=sp)
            e = dict(m=m, r=r, gram=eq(tg.blocks, gram.blocks[i]), factor=eq(tf.blocks, f.blocks[i]),
                     factor_per_entry=eq(tf.blocks, one.blocks))
            rp = torch.zeros((N, R), device=dev)
            if op == "lstsq":
                trhs = _dot_tn(ta, tb, torch.float32)
                e.update(rhs=eq(trhs, rhs[i, :, :r]),
                         rhs_m=eq(trhs, _dot_tn(At[i], Bt[i, :, :r].contiguous(), torch.float32)),
                         rhs_r=eq(trhs, _dot_tn(ta, Bt[i, :m], torch.float32)[:, :r]),
                         rhs_batch=eq(rhs[i], _dot_tn(At[i], Bt[i], torch.float32)))
                rp[:, :r] = trhs
                e["subst_r"] = eq(solve_cholesky(tf, trhs, plan=twin),
                                  solve_cholesky(tf, rp, plan=twin)[:, :r])
                ref = lstsq(ta, tb, ridge=rd, plan=twin)
            else:
                rp[:, :r] = tb
                ref = solve_triangular(tf, tb, transpose=False, plan=twin)
                e["subst_r"] = eq(ref, solve_triangular(tf, rp, transpose=False,
                                                        plan=twin)[:, :r])
            e["x"] = eq(ref, x[i, :, :r])
            entries.append(e)
        keys = [k for k in entries[0] if k not in ("m", "r")]
        row = dict(bucket=f"{op}:m{M}:n{N}:r{R}:b{B}", device=str(dev),
                   plan=dict(n_base=sp.n_base, packed_block=sp.packed_block,
                             use_kernels=sp.use_kernels),
                   equal={k: sum(e[k] for e in entries) for k in keys}, entries=len(entries),
                   differ={k: [(e["m"], e["r"]) for e in entries if not e[k]] for k in keys})
        print(json.dumps(row), flush=True)
        rows_out.append(row)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(rows_out, fh, indent=1)
    differ = sum(len(v) for row in rows_out for v in row["differ"].values())
    print(f"{differ} stage mismatches over {len(rows_out)} bucket shapes", flush=True)
    return 1 if differ and dev.type == "cuda" else 0


if __name__ == "__main__":
    sys.exit(main())
