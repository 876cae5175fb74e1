"""The frozen DCN arm, JAX against the port, on both packages' exports
(CPU, small size): where does ``DCN_SENSITIVITY_TORCH_TG_FROZEN.json``'s
``real`` arm part from the JAX record's?

    python tests/torch_port_dcn_bisect.py --out dcn_bisect.json

Both packages pre-train PMGT with the sensitivity tool's arguments
(``tools/dcn_sensitivity.py:81-90``, fewer epochs) on the same synthetic
dataset and export it; then each package's DCN trains the frozen ``real``
arm (``run_dcn`` with ``--freeze``) on each export over a few seeds, and
the ``plain`` arm beside it. Four cells: if each DCN gives the same AUC on
the same export, the DCN path agrees and the records part where the
exports do. ``--same-init`` starts each port DCN from the JAX run's
initial parameters, which leaves the two packages' draws (negatives,
batch order, dropout) as the only difference. The JAX runs need the JAX
package, so this is a script beside the tests (it imports both) rather
than part of the port.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import torch  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from pmgt_tpu.core.config import TrainArgs as JTrainArgs  # noqa: E402
from pmgt_tpu.data.synthetic import make_synthetic_dataset as jmake  # noqa: E402
from pmgt_tpu.tasks import dcn_task as jdcn  # noqa: E402
from pmgt_tpu.tasks import pmgt_task as jpmgt  # noqa: E402
from pmgt_tpu.train.registry import RunRegistry as JRegistry  # noqa: E402
from pmgt_tpu_torch.data.synthetic import make_synthetic_dataset as tmake  # noqa: E402
from pmgt_tpu_torch.models.interop import dcn_params_from_flax  # noqa: E402
from pmgt_tpu_torch.tasks import dcn_task as tdcn  # noqa: E402
from pmgt_tpu_torch.tasks import pmgt_task as tpmgt  # noqa: E402
from pmgt_tpu_torch.tools import dcn_sensitivity as ds  # noqa: E402
from pmgt_tpu_torch.tools import validate_pipeline as vp  # noqa: E402
from pmgt_tpu_torch.train.registry import RunRegistry as TRegistry  # noqa: E402


def jax_run(task, args, art, registry, name, export_path=None, init=None):
    """One JAX stage (tools/dcn_sensitivity.py:91-101, :139-147); ``init``
    gets the task's parameters before training."""
    c = {"artifacts": art}
    task.check_args(args)
    task.init_run(args)
    task.init_dataloader(args, c)
    task.init_model(args, c)
    if init is not None:
        init(jax.tree.map(np.asarray, c["task"].state.params))
    run = registry.create_run(name, args.to_dict())
    task.train(args, c, registry, run)
    if export_path is not None:
        args.inference_result_path = export_path
        task.inference(args, c, registry, run)
        return None
    return task.test(args, c, registry, run)["test/auc"]


def paired_dcn(args, jart, tart, jreg, treg, name, same_init):
    """The JAX DCN run, then the port's; with ``same_init`` the port's
    model starts from the JAX task's initial parameters (the injected
    table included). Returns (port AUC, JAX AUC)."""
    start = {}
    jauc = jax_run(jdcn, jax_args(args), jart, jreg, name,
                   init=(lambda p: start.update(dcn_params_from_flax(p))) if same_init else None)
    ctx = {"artifacts": tart, "device": "cpu"}
    tdcn.check_args(args)
    tdcn.init_run(args)
    tdcn.init_dataloader(args, ctx)
    tdcn.init_model(args, ctx)
    if same_init:
        ctx["task"].model.load_state_dict(start)
    run = treg.create_run(name, args.to_dict())
    tdcn.train(args, ctx, treg, run)
    return tdcn.test(args, ctx, treg, run)["test/auc"], jauc


def jax_args(port_args):
    """The port's ``TrainArgs`` as the JAX package's (the same fields)."""
    d = dataclasses.asdict(port_args)
    return JTrainArgs(**{k: v for k, v in d.items() if k != "extra"}, extra=dict(d["extra"]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--num-nodes", type=int, default=1500)
    ap.add_argument("--num-users", type=int, default=1000)
    ap.add_argument("--pmgt-epochs", type=int, default=3)
    ap.add_argument("--downstream-epochs", type=int, default=4)
    ap.add_argument("--seeds", default="0,1,2,3,4")
    ap.add_argument("--same-init", action="store_true",
                    help="start each port DCN from the JAX task's initial parameters")
    ap.add_argument("--out", default="dcn_bisect.json")
    cli = ap.parse_args(argv)
    torch.set_num_threads(2)
    work = tempfile.mkdtemp(prefix="dcn_bisect_")
    data = dict(num_nodes=cli.num_nodes, num_users=cli.num_users, feat_dims=(64, 32), seed=42)
    jart, tart = jmake(**data), tmake(**data)
    assert np.array_equal(jart.train_pairs, tart.train_pairs)
    ns = ds.parse(["--out", work, "--freeze", "--pmgt-epochs", str(cli.pmgt_epochs),
                   "--downstream-epochs", str(cli.downstream_epochs), "--device", "cpu"])
    jreg, treg = JRegistry(f"{work}/jlogs"), TRegistry(f"{work}/tlogs")
    exports = {"jax": f"{work}/jax_emb.npy", "port": f"{work}/port_emb.npy"}
    jax_run(jpmgt, jax_args(ds.pmgt_args(ns)), jart, jreg, "PMGT", exports["jax"])
    vp.run_task(tpmgt, ds.pmgt_args(ns), tart, treg, "PMGT", "cpu", export_path=exports["port"])
    seeds = [int(s) for s in cli.seeds.split(",")]
    auc = {}
    for seed in seeds:
        for origin, emb in (("plain", None), *exports.items()):
            arm = "plain" if emb is None else f"real frozen, {origin} export"
            port, jaxs = paired_dcn(ds.dcn_args(ns, seed, emb, f"{work}/tlogs"), jart, tart, jreg,
                                    treg, arm, cli.same_init)
            auc.setdefault(f"{arm}/port dcn", []).append(port)
            auc.setdefault(f"{arm}/jax dcn", []).append(jaxs)
        print(json.dumps({k: v[-1] for k, v in auc.items()}), flush=True)
    out = {"data": data, "seeds": seeds, "pmgt_epochs": cli.pmgt_epochs,
           "downstream_epochs": cli.downstream_epochs, "same_init": cli.same_init, "auc": auc,
           "summary": {k: vp.mean_std(v) for k, v in auc.items()}}
    with open(cli.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out["summary"], indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
