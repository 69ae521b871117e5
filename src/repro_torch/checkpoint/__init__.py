from .manager import (CheckpointManager, is_checkpoint_dir, load_pytree, load_pytree_dict,
                      read_leaves, save_pytree)
from .release import (
    ReleaseError,
    find_release,
    load_release_params,
    params_sha256,
    verify_release,
    warn_no_release,
    write_release,
)
