"""MGG core for the port: host planning (copied from the reference), the
pipelined ring aggregation over a virtual ring (differentiable; dense or
top-k compressed), the bulk and fetch baselines, and the GNNs on top:
GCN, GIN, GraphSAGE (full-graph and sampled blocks), GAT."""
from .graph import (CSRGraph, erdos_renyi, power_law, paper_dataset,
                    PAPER_DATASETS, neighbors_of, khop_in_frontier)
from .partition import (edge_balanced_node_split, locality_edge_split,
                        neighbor_partitions, NeighborPartitions,
                        VirtualGraphs)
from .placement import (AggregationPlan, SharedPartition, LayerPlan,
                        build_partition, plan_from_partition, build_plan,
                        build_layer_plans, build_bulk_plan,
                        build_fetch_plan, pad_table, unpad_table,
                        pad_embeddings, unpad_embeddings, pgas_rows)
from .pipeline import (WorkGroup, RingArrays, plan_device_arrays,
                       mgg_aggregate, mgg_aggregate_sparse,
                       mgg_aggregate_streamed, mgg_aggregate_sparse_streamed,
                       block_neighbor_sum, bulk_aggregate,
                       fetch_rows_aggregate, reference_aggregate, topk_activation, wire_index_dtype,
                       topk_decompress, collective_bytes,
                       sparse_collective_bytes)
from .gnn import (GNNEngine, MODEL_ZOO, MODEL_STAGES, gcn_init, gcn_apply,
                  gcn_stage, gin_init, gin_apply, gin_stage, sage_init,
                  sage_apply, sage_stage, gat_init, gat_apply, gat_stage,
                  sage_apply_blocks, apply_blocks, BLOCK_MODELS,
                  masked_cross_entropy, params_from_numpy, num_stages,
                  apply_stage, apply_from_stage, aggregation_widths)
