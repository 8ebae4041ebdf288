"""GenAI toolkit agents of the port (the JAX package's ``agents/genai``):
the expression language, the record under transformation, the transform
steps, and the completions, embeddings and query steps. Importing the
package registers every step as an agent type."""

from langstream_tpu_torch.agents.genai.agent import (  # noqa: F401
    GenAIToolKitAgent,
    register_genai_agents,
)

register_genai_agents()
