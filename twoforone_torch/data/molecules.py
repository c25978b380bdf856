"""Molecule registry: ids, normalization stds, simulation temperatures,
step-size derates, bead masses and the packaged asset paths.

Copy of ``twoforone_tpu/data/molecules.py`` (the port keeps its own copy
instead of importing the JAX package). The assets themselves (folded PDBs,
golden references, staged weights) stay where the JAX package ships them and
are read by path.
"""

from __future__ import annotations

import os
from enum import Enum

ASSETS_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "twoforone_tpu", "assets",
)
FOLDED_PDB_DIR = os.path.join(ASSETS_DIR, "folded_pdbs")
SAVED_REFERENCES_DIR = os.path.join(ASSETS_DIR, "saved_references")


class Molecules(Enum):
    CHIGNOLIN = "CLN025"
    TRP_CAGE = "2JOF"
    BBA = "1FME"
    VILLIN = "2F4K"
    WW_DOMAIN = "GTT"
    NTL9 = "NTL9"
    BBL = "2WAV"
    PROTEIN_B = "PRB"
    HOMEODOMAIN = "UVF"
    PROTEIN_G = "NuG2"
    ALPHA3D = "A3D"
    LAMBDA_REPRESSOR = "lambda"


all_molecules = ["alanine_dipeptide"] + [mol.name.lower() for mol in Molecules]

# Per-protein dataset standard deviations in Angstrom (the diffusion
# norm_factor).
norm_stds = {
    Molecules.CHIGNOLIN: 3.113133430480957,
    Molecules.TRP_CAGE: 5.08211088180542,
    Molecules.BBA: 6.294918537139893,
    Molecules.VILLIN: 6.082900047302246,
    Molecules.PROTEIN_G: 6.354289531707764,
    "alanine_fold1": 0.9449278712272644,
    "alanine_fold2": 0.944965124130249,
    "alanine_fold3": 0.9452606439590454,
    "alanine_fold4": 0.9454087018966675,
}

# Simulation/training-data temperatures in Kelvin.
temp_dict = {
    "ALANINE_DIPEPTIDE_FUBERLIN": 300,
    "ALANINE_DIPEPTIDE_MDSHARE": 300,
    "CHIGNOLIN": 340,
    "TRP_CAGE": 290,
    "BBA": 325,
    "VILLIN": 360,
    "WW_DOMAIN": 360,
    "NTL9": 355,
    "BBL": 298,
    "PROTEIN_B": 340,
    "HOMEODOMAIN": 360,
    "PROTEIN_G": 350,
    "ALPHA3D": 370,
    "LAMBDA_REPRESSOR": 350,
}

# Parallel-tempering high temperatures: the start and end of the tempering
# ramp.
temp_dict_pt = {
    "ALANINE_DIPEPTIDE_FUBERLIN": 450,
    "ALANINE_DIPEPTIDE_MDSHARE": 450,
    **{m.name: 500 for m in Molecules},
}

# Measured BAOAB step-size derates for extracted-force-field Langevin (the
# ``dt_scale`` argument of LangevinDiffusion). BAOAB's stationary bias grows
# with dt and with system size; at the auto-dt default the villin-scale
# control fails its physics bar (TIC-JS 0.1115 > 0.10) and the values below
# pass it (assets/trained/chain35 and chain56 results.json). Sizes without a
# measured entry fall back to the size rule in :func:`default_dt_scale`.
langevin_dt_scale_dict = {
    "ALANINE_DIPEPTIDE_FUBERLIN": 1.0,
    "ALANINE_DIPEPTIDE_MDSHARE": 1.0,
    "CHIGNOLIN": 1.0,   # N=10 (assets/trained/chain10)
    "TRP_CAGE": 1.0,    # N=20 (assets/trained/chain20)
    "BBA": 0.35,        # N=28 (chain28; 0.5 failed the bar at 0.1031)
    "VILLIN": 0.5,      # N=35 (chain35; 1.0 fails at 0.1115)
    "PROTEIN_G": 0.35,  # N=56 (chain56)
}


def default_dt_scale(mol_name: str, num_beads: int = None) -> float:
    """Production default for the Langevin ``dt_scale`` argument.

    The measured per-protein value where a trained control validated it
    (``langevin_dt_scale_dict``); otherwise a size rule between the measured
    regimes (<25 beads: 1.0; 25-49: 0.5; >=50: 0.35). The sampling CLI uses
    it when ``--dt_scale`` is not given.
    """
    knob = langevin_dt_scale_dict.get(mol_name.upper())
    if knob is not None:
        return knob
    if num_beads is None or num_beads < 25:
        return 1.0
    return 0.5 if num_beads < 50 else 0.35


# Physics constants: Boltzmann constant in g/mol * Angstrom^2 / ps^2 / K,
# plus SI anchors for the kcal variant.
KBOLTZMANN = 1.38064852e-23
AVOGADRO = 6.022140857e23
JPERKCAL = 4184
KB = 0.83144626181

# Bead masses in g/mol.
MASS_ALA2 = 12.8
MASS_FASTFOLDER = 12.0


def folded_pdb_path(mol_name: str, ca_only: bool = True) -> str:
    """Path to the packaged folded structure of a molecule."""
    if "alanine" in mol_name.lower():
        return os.path.join(FOLDED_PDB_DIR, "ala2_cg.pdb")
    protid = Molecules[mol_name.upper()].value
    fname = f"{protid}-0-c-alpha.pdb" if ca_only else f"{protid}.pdb"
    return os.path.join(FOLDED_PDB_DIR, fname)
