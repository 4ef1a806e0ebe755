"""The plain reference: what the benchmark holds the port's training to.

Plain PyTorch in float32 with TF32 off, written from the model equations
of IBM/TM-GCN (TensorGCN-master/embedding_help_functions.py EmbeddingGCN2,
wd_gcn_functions.py WD_GCN) and its preprocessing (read_data.py). It
imports nothing of the port and reads nothing the port made: it works out
the windows, the M-transform, the normalisation and the degree features
again from the raw edges it is handed.

One module per model family (``tmgcn2``, ``wdgcn``), each with
``param_shapes``, ``prepare`` and ``logits``; ``data`` turns raw edges
into the family's inputs; ``train`` follows the first SGD steps and scores
the evaluation windows. Every product goes through ``ops.mm`` or
``ops.spmm``, which round their operands to TF32 when asked: that is the
control, the step in precision below the float32 the configurations state.
"""
