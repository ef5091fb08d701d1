from repro_torch.utils.tree import (  # noqa: F401
    tree_flatten, tree_leaves, tree_map, tree_paths, tree_unflatten,
)
