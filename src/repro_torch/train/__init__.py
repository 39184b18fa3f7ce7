"""Training-side entry points of the port: so far the scoring path
(``train_step.lm_loss`` / ``make_eval_step``)."""
