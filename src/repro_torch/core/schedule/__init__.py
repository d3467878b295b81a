from repro_torch.core.schedule.tile_graph import (  # noqa: F401
    Buffer, Group, OpSpec, TileGraph,
    attention_tile_graph, matmul_tile_graph, mlp_tile_graph,
)
from repro_torch.core.schedule.minlp import MINLPSolver, Schedule  # noqa: F401
from repro_torch.core.schedule.mcts import MCTS, auto_schedule  # noqa: F401
from repro_torch.core.schedule.ntt import MICRO_KERNELS, ukernel_time  # noqa: F401
