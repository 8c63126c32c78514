"""Evaluation of reconstructed meshes: Chamfer-L1/L2, F-score, Hausdorff and
occupancy IoU (``metrics``), ICP alignment (``icp``) and the evaluation CLI
(``python -m slice3d_tpu_torch.eval``, ``cli``)."""
