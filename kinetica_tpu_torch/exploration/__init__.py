from .cde import CDE, ingest_cde_run
from .cde_utils import env_multithread, parallel_run
from .explore_utils import (cleanup_network, identify_next_seeds,
                            import_mechanism, import_mechanism_inplace,
                            import_network, load_current_seeds,
                            load_past_seeds, make_inert_file, make_rcount,
                            setup_level)
from .location import ExploreLoc, find_current_loc
from .methods import (DirectExplore, IterativeExplore, explore_network,
                      explore_subspace)
from .molecule_system import (molsys_opt, system_from_mols,
                              system_from_smiles)

__all__ = [
    "CDE", "ingest_cde_run", "env_multithread", "parallel_run",
    "cleanup_network", "identify_next_seeds", "import_mechanism",
    "import_mechanism_inplace", "import_network", "load_current_seeds",
    "load_past_seeds", "make_inert_file", "make_rcount", "setup_level",
    "ExploreLoc", "find_current_loc",
    "DirectExplore", "IterativeExplore", "explore_network",
    "explore_subspace",
    "molsys_opt", "system_from_mols", "system_from_smiles",
]
