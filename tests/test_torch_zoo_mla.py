"""The port's DeepSeek-V2-236B (MLA, 160 experts) against the JAX package,
on its ``reduced_config`` (2 layers, d_model 256, MLA's q / k heads of
48 and v heads of 32, 4 experts, float32 compute): the stacked init,
``forward`` logits and the MoE aux loss, ``train_loss`` and its gradient
into the trainable tree, one federated step. The cases and their
tolerances are ``tests/_torch_zoo_cases.py``'s.
"""
from _torch_zoo_cases import (  # noqa: F401
    _one_intra_op_thread, pytest_generate_tests,
    test_forward_logits_and_aux_match_jax, test_init_leaves_match_jax,
    test_one_federated_train_step, test_train_loss_and_gradient_match_jax)

FAMILY = ["deepseek-v2-236b"]
