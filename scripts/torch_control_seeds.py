"""How much the dipeptide positive control at the JAX package's CI tier
depends on the seed: train, sample, score, in either package.

    python3 scripts/torch_control_seeds.py jax|torch|torch_jaxinit SEED [STEPS]

Trains the score network of ``run_positive_control`` at the CI tier of
``tests/test_positive_control.py`` (5 beads, nf 48, 2 layers, 40 000 frames
of the bimodal dipeptide data of seed 0, batch 256, lr 2e-3 cosine to 1e-4,
T=250, 3500 steps unless STEPS says otherwise) with the trainer of the JAX
package (``jax``) or of the port (``torch``: weights from the port's
``init_params``; ``torch_jaxinit``: from the JAX package's flax ``init``), the
trainer's seed being SEED; then draws 512 i.i.d. samples through the full
reverse chain and prints one JSON line: the pairwise-distance and dihedral
JS against the reference draw (seed 1) and the final validation loss. Runs
on the CPU (JAX at float32 "highest" precision), ~10-15 min a run.
"""

import json
import os
import sys
import tempfile
import time

os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_default_matmul_precision", "highest")

import numpy as np  # noqa: E402
import torch  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from twoforone_tpu.train import positive_control as jpc  # noqa: E402
from twoforone_tpu.data import synthetic  # noqa: E402

EDGES = dict(use_intrinsic_coords=True, use_abs_coords=False, use_distances=False)
PDB = os.path.join(ROOT, "twoforone_tpu", "assets", "folded_pdbs", "ala2_cg.pdb")


def main(which, seed, steps=3500):
    torch.set_num_threads(2)
    if which == "jax":
        from twoforone_tpu.core.diffusion import GaussianDiffusion
        from twoforone_tpu.data.datasets import CGDataset
        from twoforone_tpu.data.pdb import load_pdb
        from twoforone_tpu.models.graph_transformer import GraphTransformer
        from twoforone_tpu.train.trainer import Trainer
        from twoforone_tpu.utils.config import TrainConfig
        extra = {}
    else:
        from twoforone_torch.core.diffusion import GaussianDiffusion
        from twoforone_torch.data.datasets import CGDataset
        from twoforone_torch.data.pdb import load_pdb
        from twoforone_torch.models.graph_transformer import GraphTransformer
        from twoforone_torch.train.trainer import Trainer
        from twoforone_torch.utils.config import TrainConfig
        extra = dict(device="cpu")
    data = synthetic.bimodal_dipeptide_dataset(40000, seed=0)
    reference = synthetic.bimodal_dipeptide_dataset(2048, seed=1)
    topology = load_pdb(PDB).topology
    sets = tuple(CGDataset(part, topology, "alanine_fold1", mean0=True)
                 for part in (data[:28000], data[28000:32000], data[32000:]))
    gd = GaussianDiffusion(model=GraphTransformer(num_beads=5, hidden_nf=48, n_layers=2,
                                                  conservative=True, **EDGES),
                           num_atoms=5, timesteps=250, norm_factor=float(sets[0].data.std()),
                           loss_weights="ones")
    folder = tempfile.mkdtemp(prefix="control_seeds_")
    cfg = TrainConfig(
        mol="alanine_dipeptide_fuberlin", data_folder=None, results_folder=folder,
        tensorboard_folder=os.path.join(folder, "runs"), experiment_name="seeds",
        hidden_features_gnn=48, num_layers_gnn=2, diffusion_steps=250, loss_weights="ones",
        conservative=True, batch_size=256, learning_rate=2e-3, min_lr_cosine_anneal=1e-4,
        train_iter=steps, eval_interval=steps, iterations_on_val=1,
        log_tensorboard_interval=100, num_samples=64, num_samples_final_eval=64,
        eval_langevin=False, seed=seed, **EDGES)
    trainer = Trainer(gd, sets, "alanine", cfg, use_tensorboard=False, evaluators=False, **extra)
    if which == "torch_jaxinit":
        from twoforone_tpu.core.diffusion import GaussianDiffusion as JGD
        from twoforone_tpu.models.graph_transformer import GraphTransformer as JGT
        from twoforone_torch.utils.convert import params_from_jax

        jgd = JGD(model=JGT(num_beads=5, hidden_nf=48, n_layers=2, conservative=True, **EDGES),
                  num_atoms=5, timesteps=250)
        weights = params_from_jax(jax.tree_util.tree_map(
            np.asarray, jgd.init_params(jax.random.PRNGKey(seed))))
        trainer.net.load_state_dict(weights)
        trainer.ema.load_state_dict(weights)
    t0 = time.time()
    trainer.train()
    samples = np.asarray(trainer.sample(512))
    print(json.dumps(dict(
        trainer=which, seed=seed, steps=steps, val_loss=float(trainer.best_val_loss),
        pwd_js_iid=jpc.pwd_js(samples, reference),
        dihedral_js_iid=jpc.dihedral_js(samples, reference, n_bins=31),
        wall_s=time.time() - t0)), flush=True)


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), *(int(a) for a in sys.argv[3:4]))
