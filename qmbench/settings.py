"""A configuration file's settings as the port's objects, and the TF32
switch of the control."""
import dataclasses


def qm_config(config_module, cfg):
    """QmConfig of `config_module` (the port's config.py) with the file's
    MPC and WBC settings over the defaults."""
    qc = config_module.QmConfig()
    qc = qc.with_(mpc=config_module.MpcConfig(**cfg["mpc"]))
    return qc.with_(wbc=dataclasses.replace(qc.wbc, **cfg["wbc"]))


def model_and_info(models_package, centroidal_module):
    """(RobotModel, CentroidalInfo) of the robot the port ships."""
    model = models_package.load_model()
    return model, centroidal_module.make_centroidal_info(model)


def tf32(on):
    """Turn TF32 products on or off for float32 CUDA matmuls; returns the
    previous setting."""
    import torch
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    return prev
