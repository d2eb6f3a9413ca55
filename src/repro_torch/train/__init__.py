"""Training on the port: AdamW (``optimizer``), the train step with remat
(``train_step``), checkpoints (``checkpoint``), int8 gradient compression
(``compression``) and restartable training (``fault_tolerance``)."""
