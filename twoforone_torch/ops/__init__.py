from twoforone_torch.ops.geometry import (  # noqa: F401
    center_zero,
    assert_center_zero,
    random_rotation,
    reverse_rotation,
    pairwise_distances,
    pwd_triu_batch,
    dihedrals,
    kabsch_rmsd,
)
