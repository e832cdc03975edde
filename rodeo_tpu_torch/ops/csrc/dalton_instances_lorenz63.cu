// The instances of DALTON's filter K8 (dalton_filter_batch.cuh) for
// Lorenz63 at q = 3, under kramer and rodeo, with and without data.
#include "dalton_filter_batch.cuh"

namespace rodeo {

template struct DaltonFilterInstances<Lorenz63, 3>;

}  // namespace rodeo
