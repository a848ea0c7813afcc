"""The GNN family: GraphSAGE, GatedGCN, DimeNet and EquiformerV2 over padded
edge lists, their message passing through ``segment_sum``'s kernel."""
