from twoforone_torch.data.molecules import (  # noqa: F401
    Molecules,
    all_molecules,
    norm_stds,
    temp_dict,
    temp_dict_pt,
)
from twoforone_torch.data.pdb import Topology, load_pdb, save_pdb, process_pdb  # noqa: F401
from twoforone_torch.data.datasets import CGDataset, get_dataset  # noqa: F401
