"""Star-tree cubes (copies of pinot_tpu/startree/)."""
from pinot_tpu_torch.startree.cube import (StarTreeConfig, StarTreeCube,
                                           build_star_trees,
                                           load_star_trees)
from pinot_tpu_torch.startree.executor import try_star_tree_execute

__all__ = ["StarTreeConfig", "StarTreeCube", "build_star_trees",
           "load_star_trees", "try_star_tree_execute"]
