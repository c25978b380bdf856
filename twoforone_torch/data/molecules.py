"""Molecule registry: normalization stds, temperatures and unit constants.

Copy of the tables in ``twoforone_tpu/data/molecules.py`` that the Langevin
path needs (the port keeps its own copy instead of importing the JAX
package).
"""

from __future__ import annotations

from enum import Enum


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

# Physics constants: Boltzmann constant in g/mol * Angstrom^2 / ps^2 / K,
# plus SI anchors for the kcal variant.
KBOLTZMANN = 1.38064852e-23
AVOGADRO = 6.022140857e23
JPERKCAL = 4184
KB = 0.83144626181
