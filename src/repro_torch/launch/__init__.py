"""Launchers of the port: serving (:mod:`repro_torch.launch.serve`) and
training (:mod:`repro_torch.launch.train`)."""
