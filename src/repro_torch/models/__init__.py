"""Models of the port: the DeepFM measure and its trainable recommender
(``deepfm``), the shared building blocks, LM layers and attention layers
(``layers``), the recommendation nets with their embedding ops
(``recsys``: DLRM, DCN-v2, BST, BERT4Rec), the dense and MoE decoder
family (``transformer``, ``moe``) and GIN (``gnn``)."""
