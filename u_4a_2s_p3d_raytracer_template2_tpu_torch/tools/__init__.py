"""The port's device tools: counterparts of the repo's ``tools/`` scripts
that reach a TPU kernel, run on the card through csrc/probes.cu, and a
study of the two megakernels' builds (``megakernels``).

    python -m u_4a_2s_p3d_raytracer_template2_tpu_torch.tools.probe_features
    python -m u_4a_2s_p3d_raytracer_template2_tpu_torch.tools.device_validate
    python -m u_4a_2s_p3d_raytracer_template2_tpu_torch.tools.roofline_mount all
    python -m u_4a_2s_p3d_raytracer_template2_tpu_torch.tools.megakernels

The first three run on the card unless given ``--device cpu``, where they
run the plain versions only and say so; ``megakernels`` needs the card.
"""
