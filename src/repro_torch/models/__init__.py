"""Models of the port: the DeepFM measure and its trainable recommender
(``deepfm``), the shared building blocks and attention layers
(``layers``), and the recommendation nets with their embedding ops
(``recsys``: DLRM, DCN-v2, BST, BERT4Rec)."""
