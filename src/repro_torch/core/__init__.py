"""MGG core for the port: host planning (copied from the reference), the
pipelined ring aggregation over a virtual ring (differentiable), and the
GNNs on top: GCN, GIN, GraphSAGE (full-graph and sampled blocks), GAT."""
from .graph import (CSRGraph, erdos_renyi, power_law, paper_dataset,
                    PAPER_DATASETS, neighbors_of, khop_in_frontier)
from .partition import (edge_balanced_node_split, locality_edge_split,
                        neighbor_partitions, NeighborPartitions,
                        VirtualGraphs)
from .placement import (AggregationPlan, SharedPartition, LayerPlan,
                        build_partition, plan_from_partition, build_plan,
                        build_layer_plans, pad_table, unpad_table,
                        pad_embeddings, unpad_embeddings, pgas_rows)
from .pipeline import (WorkGroup, RingArrays, plan_device_arrays,
                       mgg_aggregate, block_neighbor_sum, reference_aggregate)
from .gnn import (GNNEngine, MODEL_ZOO, MODEL_STAGES, gcn_init, gcn_apply,
                  gcn_stage, gin_init, gin_apply, gin_stage, sage_init,
                  sage_apply, sage_stage, gat_init, gat_apply, gat_stage,
                  sage_apply_blocks, apply_blocks, BLOCK_MODELS,
                  masked_cross_entropy, params_from_numpy, num_stages,
                  apply_stage, apply_from_stage, aggregation_widths)
