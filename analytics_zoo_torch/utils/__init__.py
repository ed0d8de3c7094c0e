"""Summaries and the TensorBoard event writer (port of the JAX
package's ``utils/summary.py`` and ``utils/tb_writer.py``)."""
