// The instances of K11c (dalton_filter_batch_tan.cuh) for Lorenz63 at q = 3,
// under kramer and rodeo, with and without data.
#include "dalton_filter_batch_tan.cuh"

namespace rodeo {

template struct DaltonFilterTanInstances<Lorenz63, 3>;

}  // namespace rodeo
