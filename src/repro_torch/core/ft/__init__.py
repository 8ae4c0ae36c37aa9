"""§6.1 fault-tolerant pretraining: failure taxonomy and logs (``events``,
``log_agent``), diagnosis, detection, loss-spike rollback, asynchronous
checkpoints of torch trees (``checkpoint``) and the auto-restart
``supervisor``. All but ``checkpoint`` are the JAX package's modules, copied;
``checkpoint`` keeps its on-disk layout, so a checkpoint written by either
package restores in the other."""
